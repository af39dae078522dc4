"""The host-side plan of K23 and K24 on the streaming body
(``tpu_llama_torch.ops.fused_layer``: ``span_phases``, ``span_layout``,
``span_workspace``, ``span_scratch``), held on the CPU against the layout the
CUDA source lays out (csrc/fused_step2.cuh make_span, lay_phases,
span_group; constants read from the headers): at Llama-2 7B's local widths
for tp 1 / 2 / 4 / 8 and 1 to 37 rows, the workspace's regions -- the row
groups' counters, the exit count, each group's tickets and partials -- lie
apart inside its words; and the block partition the source's block_range
takes for the spans (modelled here by ``_block_units``; the card tests hold
its launches bit for bit at B 1 to 37) gives every unit of every phase of
every row group to some block exactly once, and every group's chunks add up
to its ticket's total."""

import re
from pathlib import Path

import pytest
import torch

from tpu_llama_torch.ops import fused_layer as tfl

CSRC = Path(tfl.__file__).resolve().parents[1] / "csrc"
TP_SIZES = (1, 2, 4, 8)
ROWS = (1, 5, 8, 9, 32, 33, 37)
# blocks of a launch: two an SM of the H100's 132 (the span launches), four,
# and a few odd grids
BLOCKS = (264, 528, 132, 37, 1)


def _header_ints(*names):
    """``constexpr int name = expr;`` constants of the csrc headers, each
    expression evaluated over the ones read before it."""
    vals = {}
    for name in names:
        for key, expr in re.findall(r"constexpr int (\w+) = ([^;/]+);", (CSRC / name).read_text()):
            try:
                vals[key] = int(eval(expr, {}, dict(vals)))
            except NameError:
                pass
    return vals


def _block_units(groups: int, nch: int, blocks: int) -> list[tuple[int, int]]:
    """Each block's contiguous range [u0, u1) of a phase's groups * nch
    units, group-major, as csrc/fused_step2.cuh block_range gives the spans
    (aligned): whole groups where there are at least as many groups as
    blocks, so that no group's sum goes through the partials; else an equal
    share of the units, groups split along K."""
    if groups >= blocks:
        return [(groups * b // blocks * nch, groups * (b + 1) // blocks * nch)
                for b in range(blocks)]
    units = groups * nch
    return [(units * b // blocks, units * (b + 1) // blocks) for b in range(blocks)]


def _widths(kernel, tp):
    D, H, QO = 4096, 11008 // tp, 12288 // tp
    return D, (H if kernel == "K23" else QO)


def test_plan_constants_match_the_headers():
    k = _header_ints("fused_decode.cuh", "fused_step2.cuh")
    assert (tfl.ROWS_U, tfl.SPAN_CHUNK, tfl.SPAN_PITCH, tfl.FLOW_WORDS) == (
        k["kRowsU"], k["kSpanChunk"], k["kSpanPitch"], k["kFlowWords"])
    assert tfl.MAX_ROWS == k["kMaxRows"]
    flow_words = 4 + 3 + 1 + 1 + 7 + k["kMaxRows"]  # fused_step2.cuh struct Flow
    assert flow_words <= tfl.FLOW_WORDS


@pytest.mark.parametrize("kernel", ["K23", "K24"])
@pytest.mark.parametrize("tp", TP_SIZES)
@pytest.mark.parametrize("B", ROWS)
def test_span_units_cover_every_unit_once(kernel, tp, B):
    """Every block's contiguous share of each phase, over every grid: the
    shares tile [0, groups * chunks) in order, so each (group, chunk) unit
    is streamed once per row group, and each group's shares add up to its
    chunk count (the ticket's total, which exactly one share completes);
    where the groups are at least as many as the blocks, every group is one
    block's alone (no partials)."""
    D, N = _widths(kernel, tp)
    lay = tfl.span_layout(kernel, B, D, N)
    assert lay["groups"] == -(-B // tfl.MAX_ROWS)
    rows = [min(tfl.MAX_ROWS, B - g * tfl.MAX_ROWS) for g in range(lay["groups"])]
    assert sum(rows) == B and all(1 <= r <= tfl.MAX_ROWS for r in rows)
    for _, groups, nch, _ in tfl.span_phases(kernel, D, N):
        units = groups * nch
        for blocks in BLOCKS:
            shares = _block_units(groups, nch, blocks)
            seen = torch.zeros(units, dtype=torch.int32)
            for u0, u1 in shares:
                seen[u0:u1] += 1
            assert bool((seen == 1).all()), (blocks, units)
            assert [s[0] for s in shares[1:]] == [s[1] for s in shares[:-1]]
            per_group = torch.zeros(groups, dtype=torch.int64)
            completers = torch.zeros(groups, dtype=torch.int64)
            for u0, u1 in shares:
                u = u0
                while u < u1:  # a share's run within one group: its chunks [c0, c1)
                    gi, c0 = divmod(u, nch)
                    c1 = min(nch, c0 + (u1 - u))
                    per_group[gi] += c1 - c0
                    completers[gi] += per_group[gi] == nch
                    u += c1 - c0
            assert bool((per_group == nch).all()) and bool((completers == 1).all())
            if groups >= blocks:
                assert all(u0 % nch == 0 and u1 % nch == 0 for u0, u1 in shares)


@pytest.mark.parametrize("kernel", ["K23", "K24"])
@pytest.mark.parametrize("tp", TP_SIZES)
@pytest.mark.parametrize("B", ROWS)
def test_span_layout_regions_lie_apart(kernel, tp, B):
    """The row groups' Flows, the exit count and each row group's tickets
    and partials [MAX_ROWS, columns] of its phases lie apart, in that order,
    inside the workspace's words; the groups of a phase match the source's
    phase_groups (w13: 8 columns a group, the others 16 rows)."""
    D, N = _widths(kernel, tp)
    lay = tfl.span_layout(kernel, B, D, N)
    phases = tfl.span_phases(kernel, D, N)
    if kernel == "K23":
        assert [p[:2] for p in phases] == [("w13", -(-N // 8)), ("w2", -(-D // 16))]
        assert [p[3] for p in phases] == [2 * N, D]
    else:
        assert [p[:2] for p in phases] == [("wqkv", -(-N // 16))]
    assert lay["exit"] == lay["groups"] * tfl.FLOW_WORDS
    assert lay["exit"] < lay["tickets"]
    tickets = sum(p[1] for p in phases)
    partials = tfl.MAX_ROWS * sum(p[3] for p in phases)
    assert lay["stride"] == -(-tickets // 4) * 4 + partials
    end = lay["tickets"]
    for g in range(lay["groups"]):
        first = lay["tickets"] + g * lay["stride"]
        assert first == end  # each group's region starts where the last ended
        end = first + -(-tickets // 4) * 4 + partials
    assert end == lay["words"]


def test_span_workspace_one_per_kernel_widths_and_groups():
    """One zeroed workspace per (card, stream, kernel, widths, row groups),
    of ``span_layout`` words; K23 at tp = 1 (K11's own D and H) gets its
    own, apart from K11's and K12's ``step2_workspace``."""
    from tpu_llama_torch.ops import fused_step2 as tfs

    ws = tfl.span_workspace("cpu", 0, "K23", 8, 64, 96)
    assert tfl.span_workspace("cpu", 0, "K23", 5, 64, 96) is ws
    assert ws.numel() == tfl.span_layout("K23", 8, 64, 96)["words"] and bool((ws == 0).all())
    others = [tfl.span_workspace("cpu", 0, "K23", 37, 64, 96),
              tfl.span_workspace("cpu", 0, "K24", 8, 64, 96),
              tfl.span_workspace("cpu", 1, "K23", 8, 64, 96),
              tfl.span_workspace("cpu", 0, "K23", 8, 64, 48),
              tfs.step2_workspace("cpu", 0, 64, 96, 128)]
    assert all(o is not ws for o in others)
    assert others[0].numel() == tfl.span_layout("K23", 37, 64, 96)["words"]
    sc = tfl.span_scratch("cpu", 0, "K23", 3, 64, 3000)
    assert [tuple(t.shape) for t in sc] == [(3, 2112), (3,), (3, 3000), (3, 2 * 2112)]
    assert [t.dtype for t in sc] == [torch.int8, torch.float32, torch.float32, torch.int8]
    assert [tuple(t.shape) for t in tfl.span_scratch("cpu", 0, "K24", 3, 4096, 48)] == [
        (3, 2 * 2112), (3,)]


@pytest.mark.parametrize("K", [1, 96, 1024, 2048, 2049, 4096, 11008, 1376])
def test_span_activation_rows_hold_every_chunk(K):
    """A span's int8 activation row (chunk-major, csrc/fused_step2.cuh
    qpos) holds each SPAN_CHUNK of K in a run of SPAN_PITCH bytes: with a
    row group of r rows, value i of row b lands at b * SPAN_PITCH + (i //
    SPAN_CHUNK) * r * SPAN_PITCH + i % SPAN_CHUNK -- inside the group's r *
    span_act_width(K) bytes, each at its own place, and a chunk's r rows
    one run (of 16-byte multiples, as a bulk copy takes)."""
    C, P = tfl.SPAN_CHUNK, tfl.SPAN_PITCH
    assert P % 16 == 0 and C % 16 == 0
    for r in (1, 5, 32):
        i = torch.arange(K)
        pos = torch.stack([b * P + (i // C) * r * P + i % C for b in range(r)])
        assert int(pos.max()) < r * tfl.span_act_width(K)
        assert pos.unique().numel() == r * K
