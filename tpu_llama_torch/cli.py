"""Flag-compatible CLI (the llama2.ts:399-524 surface).

Port of tpu_llama/cli.py:

    tpu-llama-torch <checkpoint> [-t temp] [-p topp] [-s seed] [-n steps] [-i prompt]

The same five flags, the same defaults (temperature 1.0, top-p 1.0, seed =
time, 256 steps clamped to seq_len), the same strict ``-x value`` pairs and
usage text (llama2.ts:409-423, 514-524), the prompt echoed as it is forced
and the ``achieved tok/s`` line.  Long flags: --tokenizer, --quant,
--precision, --kv-dtype, --kv-layout, --sample-device, and the port's
--device (default the card; ``--device cpu`` runs the plain versions).
The weights take the served layouts: fused wqkv / w13 (``fuse_projections``)
before any quantization.
"""

from __future__ import annotations

import sys
import time


def error_usage() -> None:
    sys.stderr.write("Usage: tpu-llama-torch <checkpoint> [options]\n")
    sys.stderr.write('Example: tpu-llama-torch model.bin -n 256 -i "Once upon a time"\n')
    sys.stderr.write("Options:\n")
    sys.stderr.write("  -t <float>  temperature, default 1.0\n")
    sys.stderr.write("  -p <float>  p value in top-p (nucleus) sampling. default 1.0 (off)\n")
    sys.stderr.write("  -s <int>    random seed, default time(NULL)\n")
    sys.stderr.write("  -n <int>    number of steps to run for, default 256. 0 = max_seq_len\n")
    sys.stderr.write("  -i <string> input prompt\n")
    sys.stderr.write("  --tokenizer <path>  tokenizer.bin path (default ./tokenizer.bin)\n")
    sys.stderr.write("  --quant int8|w8a8   INT8: group-wise weight-only (Q8_0) / W8A8\n")
    sys.stderr.write("  --precision <p>     f32 product precision: highest|default (default: highest)\n")
    sys.stderr.write("  --kv-dtype <d>      KV cache dtype: float32|bfloat16|int8\n")
    sys.stderr.write("  --kv-layout <l>     KV layout: dense|paged (paged implies int8)\n")
    sys.stderr.write("  --sample-device on  sample on the device (threefry keys; fast, NOT\n")
    sys.stderr.write("                      xorshift-compatible -- default samples on host)\n")
    sys.stderr.write("  --device <d>        cuda|cpu (default cuda, the card)\n")
    sys.exit(1)


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        error_usage()
    checkpoint = argv[0]
    args = argv[1:]

    temperature = 1.0
    topp = 1.0
    seed = 0
    steps = 256
    prompt: str | None = None
    tokenizer_path = "tokenizer.bin"
    quant: str | None = None
    precision = "highest"
    kv_dtype = "float32"
    kv_layout = "dense"
    sample_device = False
    device = "cuda"

    i = 0
    while i < len(args):
        arg = args[i]
        if i + 1 >= len(args):  # every flag takes a value (llama2.ts:410)
            error_usage()
        val = args[i + 1]
        i += 2
        if arg.startswith("--"):
            if arg == "--tokenizer":
                tokenizer_path = val
            elif arg == "--quant" and val in ("int8", "w8a8"):
                quant = val
            elif arg == "--precision" and val in ("highest", "default"):
                precision = val
            elif arg == "--kv-dtype" and val in ("float32", "bfloat16", "int8"):
                kv_dtype = val
            elif arg == "--kv-layout" and val in ("dense", "paged"):
                kv_layout = val
            elif arg == "--sample-device":
                sample_device = val in ("on", "1", "true")
            elif arg == "--device" and val in ("cuda", "cpu"):
                device = val
            else:
                error_usage()
            continue
        # reference-strict short flags: '-x value' pairs (llama2.ts:409-423)
        if not arg.startswith("-") or len(arg) != 2:
            error_usage()
        flag = arg[1]
        if flag == "t":
            temperature = float(val)
        elif flag == "p":
            topp = float(val)
        elif flag == "s":
            seed = int(val)
        elif flag == "n":
            steps = int(val)
        elif flag == "i":
            prompt = val
        else:
            error_usage()

    if seed == 0:
        seed = int(time.time() * 1000)  # llama2.ts:424

    # the heavy imports after the flags are checked, so a usage error is fast
    from tpu_llama_torch.io.tokenizer import BOS
    from tpu_llama_torch.runtime import ContinuousBatcher, Request
    from tpu_llama_torch.utils.engine_config import EngineConfig

    engine, tokenizer = EngineConfig(
        checkpoint=checkpoint, tokenizer=tokenizer_path, quant=quant, kv_dtype=kv_dtype,
        max_batch=1, precision=precision, kv_layout=kv_layout, device=device).build_engine()
    prompt_tokens = tokenizer.encode(prompt) if prompt else []
    req = Request(prompt_tokens=prompt_tokens, steps=steps, temperature=temperature, topp=topp,
                  seed=seed, device_sampling=sample_device)

    # the prompt's tokens print as they are forced (llama2.ts:502-503)
    prev = BOS
    for t in prompt_tokens:
        sys.stdout.write(tokenizer.decode_token(t, prev_token=prev))
        prev = t
    sys.stdout.flush()
    start, count = 0.0, 0

    def stream(tok: int) -> None:
        nonlocal prev, start, count
        sys.stdout.write(tokenizer.decode_token(tok, prev_token=prev))
        sys.stdout.flush()
        prev = tok
        if start == 0.0:
            start = time.time()  # the timer starts after the first token (llama2.ts:507)
        count += 1

    req.on_token = stream
    batcher = ContinuousBatcher(engine)
    batcher.submit(req)
    batcher.run()

    elapsed = max(time.time() - start, 1e-9) if start else 1e-9
    # llama2.ts:511's line (pos - 1: the untimed first token left out)
    print(f"\n\nachieved tok/s: {max(count - 1, 0) / elapsed}\n")


if __name__ == "__main__":
    main()
