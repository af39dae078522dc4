"""HTTP serving front end over the continuous batcher.

Port of tpu_llama/runtime/server.py.  A threaded JSON HTTP server feeds one
scheduler thread, the engine's sole owner: it selects the engine's card
(``torch.cuda.set_device``) before it touches a tensor, so every kernel
launches on that thread's current stream.  HTTP threads only tokenize,
enqueue and wait; they never touch a tensor.

    POST /generate  {"prompt": str, "steps": int, "temperature": float,
                     "topp": float, "seed": int, "topk": int,
                     "logprobs": int, "priority": int, "stream": bool,
                     "device_sampling": bool, "stop_on_eos": bool}
        -> {"text": str, "tokens": [int], "ttft_s": float, "n_tokens": int,
            "logprobs": [float], "top_logprobs": [[{token, logprob}]]}
        stream=true -> ndjson piece events ({"piece": str}, plus token /
        logprob / top_logprobs fields when logprobs > 0) ending in a
        {"done": true, ...} summary line
    GET  /healthz   -> {"ok": true, "active": int, "queued": int}
    GET  /metrics   -> ServingReport JSON over all finished requests
"""

from __future__ import annotations

import json
import queue
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from tpu_llama_torch.io.tokenizer import BOS, EOS, Tokenizer
from tpu_llama_torch.runtime.engine import Engine
from tpu_llama_torch.runtime.health import RequestLog, Watchdog
from tpu_llama_torch.runtime.metrics import summarize
from tpu_llama_torch.runtime.scheduler import ContinuousBatcher, Request


class LlamaServer:
    def __init__(self, engine: Engine, tokenizer: Tokenizer, host: str = "127.0.0.1",
                 port: int = 8000, request_log: str | None = None,
                 watchdog_s: float | None = None, max_chunk: int = 1, warmup: bool = False,
                 warmup_max_bucket: int | None = None):
        if warmup:
            # every prompt bucket, the decode steps and (on the card) every
            # kernel's build, before any traffic is accepted
            self.warmup_buckets = engine.warmup(max_bucket=warmup_max_bucket, chunk=max_chunk)
        self.engine = engine
        self.tokenizer = tokenizer
        self.batcher = ContinuousBatcher(engine, max_chunk=max_chunk)
        self._submit_q: "queue.Queue[tuple[Request, threading.Event]]" = queue.Queue()
        self._events: dict[int, threading.Event] = {}
        self._n_done = 0
        self._fault: Exception | None = None  # what killed the scheduler thread
        self._stop = threading.Event()
        self._log = RequestLog(request_log) if request_log else None
        self._watchdog = Watchdog(watchdog_s) if watchdog_s else None
        self._loop_thread = threading.Thread(target=self._loop, daemon=True)
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        if request_log:
            # crash recovery: re-serve journaled requests that never finished
            for req in RequestLog.replay_incomplete(request_log):
                self.batcher.submit(req)
                self._log.log_submit(req)  # journaled again under its new id

    # ---- lifecycle ----
    def start(self) -> "LlamaServer":
        if self._watchdog:
            self._watchdog.start()
        self._loop_thread.start()
        self._http_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._loop_thread.join(timeout=10)
        if self._watchdog:
            self._watchdog.stop()
        if self._log:
            self._log.close()

    # ---- scheduler thread (the engine's sole owner) ----
    def _loop(self) -> None:
        """Run the batcher; if it raises, record the fault, print its
        traceback and release every waiting request (which then fails)
        instead of leaving it to its timeout."""
        try:
            if self.engine.device.type == "cuda":  # the params' device carries its index
                torch.cuda.set_device(self.engine.params.tok_emb.device)
            self._serve()
        except Exception as e:  # noqa: BLE001 -- the engine's owner is gone: fail the waiters
            traceback.print_exc()
            self._fault = e
            for ev in self._events.values():
                ev.set()
            while not self._submit_q.empty():
                self._submit_q.get_nowait()[1].set()

    def _serve(self) -> None:
        while not self._stop.is_set():
            moved = False
            try:
                while True:
                    req, ev = self._submit_q.get_nowait()
                    rid = self.batcher.submit(req)
                    if self._log:
                        self._log.log_submit(req)
                    self._events[rid] = ev
                    moved = True
            except queue.Empty:
                pass
            if self._watchdog:
                self._watchdog.beat(active=not self.batcher.idle)
            if self.batcher.idle:
                if not moved:
                    self._stop.wait(0.005)
                continue
            self.batcher.step()
            newly = self.batcher.finished[self._n_done:]
            self._n_done = len(self.batcher.finished)
            for req in newly:
                if self._log:
                    self._log.log_done(req)
                ev = self._events.pop(req.id, None)
                if ev is not None:
                    ev.set()

    # ---- request handling (HTTP threads) ----
    def _submit(self, prompt, steps, temperature, topp, seed, device_sampling, stop_on_eos,
                on_token=None, topk=0, logprobs=0, priority=0):
        ptoks = self.tokenizer.encode(prompt) if prompt else []
        req = Request(prompt_tokens=ptoks, steps=steps, temperature=temperature, topp=topp,
                      seed=seed, device_sampling=device_sampling,
                      stop_tokens=(EOS,) if stop_on_eos else (), on_token=on_token, topk=topk,
                      logprobs=logprobs, priority=priority)
        ev = threading.Event()
        self._submit_q.put((req, ev))
        self._check_fault()  # after the put: a fault raised since has released ev
        return ptoks, req, ev

    def _check_fault(self) -> None:
        if self._fault is not None:
            raise RuntimeError(f"the scheduler thread failed: {self._fault!r}")

    def generate(self, prompt: str, steps: int = 256, temperature: float = 1.0,
                 topp: float = 1.0, seed: int = 1, timeout: float = 600.0,
                 device_sampling: bool = False, stop_on_eos: bool = False, topk: int = 0,
                 logprobs: int = 0, priority: int = 0) -> dict:
        ptoks, req, ev = self._submit(prompt, steps, temperature, topp, seed, device_sampling,
                                      stop_on_eos, topk=topk, logprobs=logprobs,
                                      priority=priority)
        if not ev.wait(timeout):
            raise TimeoutError("generation timed out")
        self._check_fault()
        prev = ptoks[-1] if ptoks else BOS
        out = {"text": self.tokenizer.decode(req.out_tokens, prev_token=prev),
               "tokens": req.out_tokens, "n_tokens": len(req.out_tokens), "ttft_s": req.ttft}
        if logprobs > 0:
            out["logprobs"] = req.out_logprobs
            out["top_logprobs"] = [[{"token": t, "logprob": lp} for t, lp in alts]
                                   for alts in req.out_top_logprobs]
        return out

    def generate_stream(self, prompt: str, steps: int = 256, temperature: float = 1.0,
                        topp: float = 1.0, seed: int = 1, timeout: float = 600.0,
                        device_sampling: bool = False, stop_on_eos: bool = False,
                        topk: int = 0, logprobs: int = 0, priority: int = 0):
        """Yields detokenized pieces as they are produced, then a summary
        dict.  With ``logprobs > 0`` each piece is a dict that carries the
        token's logprob and the top-N alternatives (host sampling, as for
        a non-streamed request with logprobs)."""
        pieces: "queue.Queue[int | None]" = queue.Queue()
        ptoks, req, ev = self._submit(prompt, steps, temperature, topp, seed, device_sampling,
                                      stop_on_eos, on_token=pieces.put, topk=topk,
                                      logprobs=logprobs, priority=priority)
        prev = ptoks[-1] if ptoks else BOS
        threading.Thread(target=lambda: (ev.wait(timeout), pieces.put(None)), daemon=True).start()
        idx = 0
        while True:
            tok = pieces.get()
            if tok is None:
                break
            piece = self.tokenizer.decode_token(tok, prev_token=prev)
            if logprobs > 0:
                # the scheduler records token i's logprobs before on_token
                # fires, so index i is in place when its token arrives
                lp = req.out_logprobs[idx] if idx < len(req.out_logprobs) else None
                tops = req.out_top_logprobs[idx] if idx < len(req.out_top_logprobs) else []
                yield {"piece": piece, "token": tok, "logprob": lp,
                       "top_logprobs": [{"token": t, "logprob": v} for t, v in tops]}
            else:
                yield piece
            prev = tok
            idx += 1
        self._check_fault()
        yield {"n_tokens": len(req.out_tokens), "ttft_s": req.ttft}

    def _make_handler(server_self):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":  # the batcher's counts only
                    self._send(200, {"ok": server_self._fault is None,
                                     "active": server_self.batcher.n_active,
                                     "queued": len(server_self.batcher.queue)})
                elif self.path == "/metrics":
                    rep = summarize(list(server_self.batcher.finished))
                    self._send(200, json.loads(rep.json_line()))
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/generate":
                    self._send(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    kwargs = dict(
                        prompt=body.get("prompt", ""),
                        steps=int(body.get("steps", 256)),
                        temperature=float(body.get("temperature", 1.0)),
                        topp=float(body.get("topp", 1.0)),
                        seed=int(body.get("seed", 1)),
                        device_sampling=bool(body.get("device_sampling", False)),
                        stop_on_eos=bool(body.get("stop_on_eos", False)),
                        topk=int(body.get("topk", 0)),
                        logprobs=int(body.get("logprobs", 0)),
                        priority=int(body.get("priority", 0)),
                    )
                    if body.get("stream"):
                        # newline-delimited JSON events; the connection's
                        # close ends the stream (HTTP/1.0 framing)
                        self.send_response(200)
                        self.send_header("Content-Type", "application/x-ndjson")
                        self.end_headers()
                        for piece in server_self.generate_stream(**kwargs):
                            if isinstance(piece, str):
                                event = {"piece": piece}
                            elif "piece" in piece:  # an event with logprobs
                                event = piece
                            else:
                                event = {"done": True, **piece}
                            self.wfile.write(json.dumps(event).encode() + b"\n")
                            self.wfile.flush()
                        return
                    self._send(200, server_self.generate(**kwargs))
                except (ValueError, KeyError) as e:  # json.JSONDecodeError is a ValueError
                    self._send(400, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 -- reported to the client as a 500
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

        return Handler


def _wait_forever(srv: LlamaServer) -> None:
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        srv.stop()


def serve(checkpoint: str, tokenizer_path: str = "tokenizer.bin", port: int = 8000,
          max_batch: int = 8, quant: str | None = None, kv_dtype: str = "float32",
          request_log: str | None = None, watchdog_s: float | None = None,
          kv_layout: str = "dense", page_size: int = 512, attn: str = "auto", fuse: bool = True,
          device: str = "cuda") -> None:
    """Blocking entry point of ``tpu-llama-torch-serve`` without a config
    file: the engine that ``EngineConfig.build_engine`` builds, on
    ``device`` (the card unless the caller asks for "cpu"), warmed up
    (every kernel built, every prompt bucket run) before it listens."""
    from tpu_llama_torch.utils.engine_config import EngineConfig

    cfg = EngineConfig(checkpoint=checkpoint, tokenizer=tokenizer_path, quant=quant,
                       kv_dtype=kv_dtype, max_batch=max_batch, kv_layout=kv_layout,
                       page_size=page_size, attn=attn, fuse=fuse, device=device)
    engine, tok = cfg.build_engine()
    srv = LlamaServer(engine, tok, port=port, request_log=request_log, watchdog_s=watchdog_s,
                      warmup=True).start()
    print(f"serving on :{srv.port} (config={engine.config}, device={engine.device})",
          flush=True)
    _wait_forever(srv)


def serve_cli(argv: list[str] | None = None) -> None:
    """Console entry: tpu-llama-torch-serve [--config engine.json] [overrides].
    The server warms up before it listens, as ``serve`` does."""
    import argparse

    ap = argparse.ArgumentParser(prog="tpu-llama-torch-serve")
    ap.add_argument("--config", help="EngineConfig JSON (tpu_llama_torch.utils)")
    ap.add_argument("--checkpoint")
    ap.add_argument("--tokenizer")
    ap.add_argument("--port", type=int)
    ap.add_argument("--max-batch", type=int)
    ap.add_argument("--quant", choices=["int8", "w8a8"])
    ap.add_argument("--kv-dtype", choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--kv-layout", choices=["dense", "paged"])
    ap.add_argument("--page-size", type=int)
    ap.add_argument("--attn", choices=["auto", "flash", "flash_dma", "xla"])
    ap.add_argument("--device", choices=["cuda", "cpu"])
    ap.add_argument("--request-log")
    ap.add_argument("--watchdog-s", type=float)
    args = ap.parse_args(argv)

    if not args.config:
        serve(checkpoint=args.checkpoint or "model.bin",
              tokenizer_path=args.tokenizer or "tokenizer.bin", port=args.port or 8000,
              max_batch=args.max_batch or 8, quant=args.quant,
              kv_dtype=args.kv_dtype or "float32", request_log=args.request_log,
              watchdog_s=args.watchdog_s, kv_layout=args.kv_layout or "dense",
              page_size=args.page_size or 512, attn=args.attn or "auto",
              device=args.device or "cuda")
        return
    from tpu_llama_torch.utils.engine_config import EngineConfig

    cfg = EngineConfig.load(args.config)
    for field, val in (("checkpoint", args.checkpoint), ("tokenizer", args.tokenizer),
                       ("quant", args.quant), ("kv_dtype", args.kv_dtype),
                       ("kv_layout", args.kv_layout), ("page_size", args.page_size),
                       ("attn", args.attn), ("max_batch", args.max_batch),
                       ("device", args.device)):
        if val is not None:
            setattr(cfg, field, val)
    for field, val in (("port", args.port), ("request_log", args.request_log),
                       ("watchdog_s", args.watchdog_s)):
        if val is not None:
            setattr(cfg.server, field, val)
    engine, tok = cfg.build_engine()
    srv = LlamaServer(engine, tok, host=cfg.server.host, port=cfg.server.port,
                      request_log=cfg.server.request_log, watchdog_s=cfg.server.watchdog_s,
                      warmup=True).start()
    print(f"serving on :{srv.port} (device={engine.device})", flush=True)
    _wait_forever(srv)


if __name__ == "__main__":
    serve_cli()
