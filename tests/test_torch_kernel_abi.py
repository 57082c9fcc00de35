"""The host side of the port's CUDA kernels, checked without a card or
``nvcc``: every ``extern "C"`` entry point in ``kubernetes_tpu_torch/csrc``
matches the ``ctypes`` argtypes ``kernels.LIBRARIES`` gives it (a wrong
count or kind would shift every later pointer on the card), the build
flags keep IEEE arithmetic, the constants the wrappers share with the
sources agree, and the wrappers' launch plans (the pair's staged / wide
route, the v pass's grid, the split u pass's grid) hold their
invariants."""

import ctypes
import os
import re

import pytest
import torch

from kubernetes_tpu_torch import kernels
from kubernetes_tpu_torch.ops import fused_score, sinkhorn

_KIND = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
         ctypes.c_float: "float"}


def _source(name):
    with open(os.path.join(kernels.CSRC, name), encoding="utf-8") as fh:
        return fh.read()


def _param_kind(decl: str) -> str:
    decl = decl.strip()
    if "*" in decl:
        return "pointer"
    words = decl.replace("const", " ").split()
    assert words, decl
    if words[0] in ("int", "float"):
        return words[0]
    raise AssertionError(f"unsupported parameter type: {decl!r}")


def _extern_c(src: str) -> dict:
    """``{function: [parameter kinds]}`` of every ``extern "C"`` function
    defined in ``src``."""
    out = {}
    for m in re.finditer(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', src):
        params = [p for p in m.group(2).split(",") if p.strip()]
        out[m.group(1)] = [_param_kind(p) for p in params]
    return out


_ENTRY_POINTS = [(lib, fn) for lib, (_src, _flags, fns) in
                 kernels.LIBRARIES.items() for fn in fns]


@pytest.mark.parametrize("lib, fn", _ENTRY_POINTS)
def test_entry_point_matches_its_argtypes(lib, fn):
    src, _flags, fns = kernels.LIBRARIES[lib]
    declared = _extern_c(_source(src))
    assert fn in declared, f"{fn} is not an extern \"C\" function of {src}"
    assert [_KIND[t] for t in fns[fn]] == declared[fn]


@pytest.mark.parametrize("lib", sorted(kernels.LIBRARIES))
def test_every_extern_c_function_is_registered(lib):
    src, _flags, fns = kernels.LIBRARIES[lib]
    assert sorted(_extern_c(_source(src))) == sorted(fns)


def test_every_source_is_built():
    built = {src for src, _flags, _fns in kernels.LIBRARIES.values()}
    on_disk = {f for f in os.listdir(kernels.CSRC) if f.endswith(".cu")}
    assert built == on_disk


def test_sinkhorn_entry_points_take_the_rule_mode():
    # the int right before the stream picks the Pallas (0) or the jnp (1)
    # rule; both passes take it, and both kernels are templated on it
    fns = kernels.LIBRARIES["sinkhorn"][2]
    assert [_KIND[t] for t in fns["ktt_sinkhorn_u"]] == [
        "pointer"] * 4 + ["int"] * 3 + ["pointer"]
    assert [_KIND[t] for t in fns["ktt_sinkhorn_v"]] == [
        "pointer"] * 7 + ["int"] * 5 + ["pointer"]
    # the split pass: p, n, the plan's (warps a row, rows, blocks), rule
    assert [_KIND[t] for t in fns["ktt_sinkhorn_u_partial"]] == [
        "pointer"] * 4 + ["int"] * 6 + ["pointer"]
    src = _source("sinkhorn.cu")
    assert re.search(r"int jnp_rule, void\* stream\) \{\n  if \(p <= 0",
                     src)
    assert "template <bool kJnp>" in src
    assert "template <bool kVec, bool kJnp>" in src


def test_graph_loop_entry_points_and_exit_test():
    # build(body, rounds, cont, max_rounds, exec_out), launch(exec,
    # stream), destroy(exec); the exit kernel keeps the reference's exits
    # (a round that admitted nobody or left nobody, or max_rounds) and
    # the loop is a WHILE node on a handle reset at every launch
    fns = kernels.LIBRARIES["graph_loop"][2]
    assert [_KIND[t] for t in fns["ktt_loop_build"]] == [
        "pointer"] * 3 + ["int", "pointer"]
    assert [_KIND[t] for t in fns["ktt_loop_launch"]] == ["pointer"] * 2
    src = _source("graph_loop.cu")
    assert "cudaGraphCondTypeWhile" in src
    assert "cudaGraphCondAssignDefault" in src
    assert re.search(r"\*cont != 0 && r < max_rounds", src)
    # CUDA 13 changed cudaGraphAddNode's signature; both are spelled out
    assert "CUDART_VERSION >= 13000" in src


def test_captured_launches_count_on_the_device_counters():
    kernels.reset_launches()
    try:
        with kernels.counting_on_device("cpu"):
            for _ in range(3):
                kernels.count_launch("sinkhorn_u", (64, 32))
            kernels.count_launch("sinkhorn_v", (64, 32))
        assert kernels.LAUNCHES["sinkhorn_u"] == 0
        kernels.collect()
        assert kernels.LAUNCHES["sinkhorn_u"] == 3
        assert kernels.LAUNCHES["sinkhorn_v"] == 1
        assert kernels.SHAPES["sinkhorn_u"] == {(64, 32): 3}
        kernels.collect()  # the counters were zeroed: nothing twice
        assert kernels.LAUNCHES["sinkhorn_u"] == 3
    finally:
        kernels._DEVICE_COUNTS.pop(("cpu", 0), None)
        kernels.reset_launches()


def test_fused_pair_is_built_without_fma_contraction():
    # bit identity with the plain version: no multiply-add may fuse
    assert "-fmad=false" in kernels.LIBRARIES["fused_pair"][1]


@pytest.mark.parametrize("lib", sorted(kernels.LIBRARIES))
def test_no_source_is_built_with_fast_math(lib):
    flags = kernels.NVCC_FLAGS + kernels.LIBRARIES[lib][1]
    for bad in ("--use_fast_math", "-use_fast_math", "-prec-div=false",
                "--prec-div=false", "-fmad=true"):
        assert bad not in flags


def test_constants_shared_with_the_sources_agree():
    pair = _source("fused_pair.cu")
    m = re.search(r"kStagedMaxN\s*=\s*(\d+)", pair)
    assert m and int(m.group(1)) == fused_score.STAGED_MAX_N
    sk = _source("sinkhorn.cu")
    m = re.search(r"kVCols\s*=\s*(\d+)", sk)
    assert m and int(m.group(1)) == sinkhorn.V_COLS
    # the v pass's grid is one wave: the blocks it plans for each SM must
    # all fit there at once
    m = re.search(r"__launch_bounds__\(kThreads,\s*(\d+)\)\s*\nv_kernel", sk)
    assert m and int(m.group(1)) >= sinkhorn.V_BLOCKS_PER_SM
    # the split u pass: the block's warps, a warp tile's columns and the
    # blocks an SM the plan counts on, which the kernel's launch bounds
    # must keep resident
    m = re.search(r"constexpr int kThreads\s*=\s*(\d+);", sk)
    assert m and int(m.group(1)) == 32 * sinkhorn.U_WARPS
    assert re.search(r"kUWarps\s*=\s*kThreads / 32;", sk)
    m = re.search(r"kUTileCols\s*=\s*(\d+);", sk)
    assert m and int(m.group(1)) == sinkhorn.U_TILE_COLS
    m = re.search(r"kUBlocksPerSm\s*=\s*(\d+);", sk)
    assert m and int(m.group(1)) == sinkhorn.U_BLOCKS_PER_SM
    assert re.search(r"__launch_bounds__\(kThreads,\s*kUBlocksPerSm\)\s*\n"
                     r"u_partial_kernel", sk)


@pytest.mark.parametrize("n, offset, staged", [
    (8192, 0, True),      # the main path's padded row
    (16, 0, True),        # the narrowest whole bulk copy of the mask row
    (12288, 0, True),     # the staged limit
    (12304, 0, False),    # past it
    (16384, 0, False),
    (8, 0, False),        # the smallest bucket: an 8-byte mask row
    (3000, 0, False),     # a multiple of 4, not of 16
    (64, 4, False),       # a mask row not 16-byte aligned
])
def test_pair_route(n, offset, staged):
    rf = torch.zeros(2, n)
    buf = torch.zeros(2 * n + 16, dtype=torch.bool)
    base = (-buf.data_ptr()) % 16
    mask = buf[base + offset: base + offset + 2 * n].view(2, n)
    assert fused_score.staged_route(n, rf, rf, mask, rf) is staged


@pytest.mark.parametrize("P, N, sms", [
    (8192, 8192, 132), (4096, 8192, 132), (5000, 3000, 132),
    (1000, 3001, 132), (96, 32, 132), (1, 8, 132), (3, 5, 1),
    (100000, 128, 132), (8192, 16384, 132),
    # the restricted frames: P_pad <= 128 against C = 256, and a
    # partitioned block's (4096, 256)
    (16, 256, 132), (128, 256, 132), (4096, 256, 132)])
def test_v_plan_covers_every_row_once(P, N, sms):
    strips, chunks, rows = sinkhorn.v_plan(P, N, sms)
    assert strips * sinkhorn.V_COLS >= N > (strips - 1) * sinkhorn.V_COLS
    assert 1 <= chunks <= sinkhorn.V_CHUNKS
    # chunk c holds rows [c*rows, min((c+1)*rows, P)): none empty, all
    # rows covered
    assert (chunks - 1) * rows < P <= chunks * rows
    # one wave: the grid fits the card's block slots unless a strip alone
    # overflows them
    assert chunks == 1 or strips * chunks <= sinkhorn.V_BLOCKS_PER_SM * sms


def test_v_plan_at_the_main_shapes():
    # on a 132-SM H100: 64 strips x 4 chunks, 256 blocks for 264 planned
    # slots (two an SM), at the padded shape and at the plan path's
    assert sinkhorn.v_plan(8192, 8192, 132) == (64, 4, 2048)
    assert sinkhorn.v_plan(4096, 8192, 132) == (64, 4, 1024)


@pytest.mark.parametrize("P, N", [
    (8192, 1024), (8192, 2048), (8192, 4096),  # a shard of 8, 4, 2
    (4096, 2048),                               # mesh arm E's plan run
    (1024, 1024), (256, 1), (64, 3), (1, 8), (100000, 128)])
def test_u_partial_plan_covers_every_row_once(P, N):
    sms = 132
    wpr, rows, blocks = sinkhorn.u_partial_plan(P, N, sms)
    assert wpr in (1, 2, 4, 8) and sinkhorn.U_WARPS % wpr == 0
    # a row is split only over warps that each get a tile of it
    assert wpr == 1 or (wpr - 1) * sinkhorn.U_TILE_COLS < N
    groups = sinkhorn.U_WARPS // wpr
    # the kernel's walk: block b, step it, group g reads row
    # b * groups * rows + it * groups + g (rows past P are skipped)
    seen = torch.zeros(P, dtype=torch.int64)
    b = torch.arange(blocks)[:, None, None]
    it = torch.arange(rows)[None, :, None]
    g = torch.arange(groups)[None, None, :]
    walk = (b * groups * rows + it * groups + g).flatten()
    seen.index_add_(0, walk[walk < P], torch.ones_like(walk[walk < P]))
    assert bool((seen == 1).all())
    # no block without a row, and the grid one wave of the card's slots
    assert (blocks - 1) * groups * rows < P
    assert 1 <= blocks <= sinkhorn.U_BLOCKS_PER_SM * sms


def test_u_partial_plan_at_the_main_shapes():
    # on a 132-SM H100, a shard of 8 of the 8192 bucket: a warp a row, two
    # rows a warp, 512 blocks for 528 slots (four an SM); mesh arm E's
    # plan run (4096 pods on 4 shards) one row a warp; a narrow batch of a
    # wide block splits its rows over four warps
    assert sinkhorn.u_partial_plan(8192, 1024, 132) == (1, 2, 512)
    assert sinkhorn.u_partial_plan(4096, 2048, 132) == (1, 1, 512)
    assert sinkhorn.u_partial_plan(64, 4096, 132) == (4, 1, 32)


def _repo_python_files():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    yield os.path.join(root, "chip_smoke.py")
    for sub in ("kubernetes_tpu_torch", "scripts"):
        for dirpath, _dirs, files in os.walk(os.path.join(root, sub)):
            yield from (os.path.join(dirpath, f) for f in files
                        if f.endswith(".py"))


def test_entry_points_are_called_from_one_place_each():
    # a C entry point is called by its wrapper module alone (the launch
    # helpers there serve the timing scripts too), so an ABI change has
    # one caller to update
    callers = {fn: set() for _lib, fn in _ENTRY_POINTS}
    for path in _repo_python_files():
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        for fn in callers:
            if re.search(rf"\.{fn}\b", text):
                callers[fn].add(os.path.basename(path))
    assert callers == {
        "ktt_fused_pair_normalize": {"fused_score.py"},
        "ktt_fused_pair_normalize_wide": {"fused_score.py"},
        "ktt_fused_pair_max": {"fused_score.py"},
        "ktt_fused_pair_scale": {"fused_score.py"},
        "ktt_sinkhorn_u": {"sinkhorn.py"},
        "ktt_sinkhorn_u_partial": {"sinkhorn.py"},
        "ktt_sinkhorn_v": {"sinkhorn.py"},
        "ktt_loop_build": {"device_loop.py"},
        "ktt_loop_launch": {"device_loop.py"},
        "ktt_loop_destroy": {"device_loop.py"},
    }


def test_launch_record_is_bounded_by_distinct_shapes():
    kernels.reset_launches()
    try:
        for shape in [(8192, 8192), (2048, 8192), (8192, 8192)] * 50:
            kernels.count_launch("fused_pair_normalize", shape)
        assert kernels.LAUNCHES["fused_pair_normalize"] == 150
        assert list(kernels.SHAPES["fused_pair_normalize"].items()) == [
            ((8192, 8192), 100), ((2048, 8192), 50)]
    finally:
        kernels.reset_launches()
    assert kernels.SHAPES["fused_pair_normalize"] == {}
    assert kernels.LAUNCHES["fused_pair_normalize"] == 0
