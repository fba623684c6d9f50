"""The grouped matmul's tile plan, on the CPU.

``gmm_plan`` (``repro_torch/kernels/moe_gmm.py``) decides from the shapes
alone which kernel of ``csrc/moe_gmm.cu`` a call runs (bf16: the
tensor-core kernel; f32: the CUDA-core one, which picks its own tile) and
how the tensor-core kernel cuts the output into tiles.  Here the bf16 plan
is checked at every serving shape of OLMoE-1B-7B, at the JAX kernel
test's shapes and at the Mixtral-8x22B and Jamba widths: every output row
and column falls in exactly one tile, and the tiles fit what ``wgmma`` and
the SM take.  The kernels run on the
card only (tests/test_torch_gpu.py); on the CPU ``ops.moe_gmm`` is the
plain version, held here against the JAX ``ops.moe_gmm`` (Pallas,
interpret mode) at the shapes of a row group and of two.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _hyp import given, settings, st  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402

from repro_torch.configs.base import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.moe_gmm import (  # noqa: E402
    SMEM_MAX, TC_MAX_TILES, TC_ROWS, GmmPlan, gmm_plan, tc_smem_bytes,
    tc_stages)

GMM_TOL = {"float32": dict(rtol=3e-5, atol=3e-5),
           "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _moe_shapes(cfg):
    """(E, d, f) of the up/gate and the down product of a config."""
    E = cfg.moe.num_experts
    return [(E, cfg.d_model, cfg.d_ff), (E, cfg.d_ff, cfg.d_model)]


OLMOE = _moe_shapes(get_config("olmoe-1b-7b"))
SERVING_C = (1, 6, 25, 40, 160, 256)
# (E, C, d, f): OLMoE's up and down at each serving C; the JAX kernel
# test's shapes (tests/test_torch_moe_model.py); Mixtral-8x22B and Jamba
# at full and smoke widths, at a decode and a chunk
SHAPES = ([(E, C, d, f) for E, d, f in OLMOE for C in SERVING_C]
          + [(4, 32, 64, 96), (2, 50, 48, 40), (8, 16, 128, 256)]
          + [(E, C, d, f)
             for name in ("mixtral-8x22b", "jamba-1.5-large-398b")
             for cfg in (get_config(name), get_smoke_config(name))
             for E, d, f in _moe_shapes(cfg) for C in (6, 160)]
          + [(3, 300, 24, 8), (2, 600, 136, 200), (1, 5, 64, 72)])


def _row_blocks(plan, C):
    """The rows of each (row block, pass, C-tile) of a plan, clipped to C."""
    for by in range(plan.grid[1]):
        for p in range(plan.passes):
            for t in range(plan.tiles):
                lo = (by * plan.passes + p) * plan.group_rows \
                    + t * plan.tile_rows
                yield range(lo, min(lo + plan.tile_rows, C))


def _check_cover(plan, C, f):
    rows = np.zeros(C, np.int64)
    for r in _row_blocks(plan, C):
        rows[list(r)] += 1
    cols = np.zeros(f, np.int64)
    for bx in range(plan.grid[0]):
        cols[bx * plan.n_tile:(bx + 1) * plan.n_tile] += 1
    assert (rows == 1).all(), rows
    assert (cols == 1).all(), cols


@pytest.mark.parametrize("E,C,d,f", SHAPES)
def test_plan_tiles_cover_the_output_once(E, C, d, f):
    plan = gmm_plan(E, C, d, f, torch.bfloat16)
    _check_cover(plan, C, f)
    assert plan.grid[2] == E


@pytest.mark.parametrize("E,C,d,f", SHAPES)
def test_plan_tiles_fit_the_card(E, C, d, f):
    """wgmma's N is a multiple of 8 up to 256 and its K a multiple of 16;
    the shared memory fits a block; 3 stages for one C-tile, 4 for more."""
    plan = gmm_plan(E, C, d, f, torch.bfloat16)
    assert plan.tensor_cores
    assert plan.n_tile % 8 == 0 and 0 < plan.n_tile <= 256
    assert plan.k_tile % 16 == 0
    assert plan.smem_bytes <= SMEM_MAX
    assert plan.tile_rows == TC_ROWS
    assert 1 <= plan.tiles <= TC_MAX_TILES and plan.grid[1] == 1
    assert plan.smem_bytes == tc_smem_bytes(plan.tiles, plan.stages)
    assert plan.stages == tc_stages(plan.tiles) == (3 if C <= TC_ROWS else 4)


@pytest.mark.parametrize("E,C,d,f", SHAPES)
def test_plan_f32_runs_the_cuda_cores(E, C, d, f):
    """f32 never takes the tensor cores (wgmma has no exact f32); its plan
    holds no tile, since the CUDA-core entry picks its own."""
    assert gmm_plan(E, C, d, f, torch.float32) == GmmPlan(False)


@pytest.mark.parametrize("E,d,f", OLMOE)
def test_plan_reads_each_weight_once_up_to_256_rows(E, d, f):
    """One pass over the weights for every serving C; a block per (128
    columns, expert): 512 blocks for up/gate, 1024 for down."""
    for C in SERVING_C:
        plan = gmm_plan(E, C, d, f, torch.bfloat16)
        assert plan.passes == 1 and plan.group_rows >= C
        assert plan.grid == (f // 128, 1, E)
    assert gmm_plan(E, 257, d, f, torch.bfloat16).passes == 2


def test_plan_depends_on_shapes_only():
    """Equal shapes give equal plans, whatever the tensors' strides: the
    plan takes no tensor, so a stride-0 view and its copy share one."""
    E, C, d, f = OLMOE[0][0], 160, OLMOE[0][1], OLMOE[0][2]
    for dtype in (torch.bfloat16, torch.float32):
        a, b = gmm_plan(E, C, d, f, dtype), gmm_plan(E, C, d, f, dtype)
        assert a == b and hash(a) == hash(b)
    x2d = torch.zeros(C, 16, dtype=torch.bfloat16)
    views = (x2d.expand(3, C, 16), x2d.expand(3, C, 16).contiguous())
    plans = {gmm_plan(*v.shape, 8, v.dtype) for v in views}
    assert len(plans) == 1
    with pytest.raises(TypeError):
        gmm_plan(E, C, d, f, torch.float16)


@settings(max_examples=60, deadline=None)
@given(E=st.integers(1, 70), C=st.integers(1, 1100),
       d=st.integers(0, 40).map(lambda k: 8 * k),
       f=st.integers(1, 40).map(lambda k: 8 * k))
def test_plan_covers_any_shape(E, C, d, f):
    plan = gmm_plan(E, C, d, f, torch.bfloat16)
    _check_cover(plan, C, f)
    assert plan.smem_bytes <= SMEM_MAX


@pytest.mark.parametrize("E,C,d,f", [(3, 70, 64, 136), (2, 300, 32, 48)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_moe_gmm_matches_jax_kernel(E, C, d, f, dtype):
    """ops.moe_gmm on the CPU (the plain version) against the JAX
    ops.moe_gmm (Pallas, interpret mode) at a C of two C-tiles and at one
    of two row groups; the tolerances of tests/test_torch_moe_model.py."""
    rng = np.random.default_rng(E + C)
    x = rng.standard_normal((E, C, d)).astype(np.float32)
    w = rng.standard_normal((E, d, f)).astype(np.float32)
    jx, jw = (jnp.asarray(a, getattr(jnp, dtype)) for a in (x, w))
    tx, tw = (torch.tensor(a).to(getattr(torch, dtype)) for a in (x, w))
    got = ops.moe_gmm(tx, tw)
    assert got.dtype == tx.dtype and tuple(got.shape) == (E, C, f)
    want = jops.moe_gmm(jx, jw, block_c=16, block_f=32, block_d=32)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **GMM_TOL[dtype])
