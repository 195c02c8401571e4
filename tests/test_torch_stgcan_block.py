"""Fused STGCAN block of the port (``ops/stgcan_block.py``) against the JAX
package's block kernel and its flax block.

The JAX kernel runs as ``tests/test_pallas_kernel.py`` runs it on the CPU
(``interpret=True``), on the cases of that file. Folding is compared at
1e-6 (the same elementwise arithmetic in both packages); block outputs at
2e-5 (float32 matmuls summed in different orders).

The JAX ``fold_block_params`` drops the residual projection's bias (it
folds only the kernel and the BN); the port folds it into ``res_shift``.
The comparisons with the JAX fold and kernel therefore zero that bias; the
comparison with the flax block keeps it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fall_multimodal_tpu.graphs import build_adjacency
from fall_multimodal_tpu.models.stgcan import STGCANBlock as JaxBlock
from fall_multimodal_tpu.ops.pallas import stgcan_block as jk
from fall_multimodal_tpu_torch.ops.stgcan_block import (
    FoldedBlockParams,
    fold_block_params,
    fused_stgcan_block,
    pack_block,
    stgcan_block_reference,
)
from torch_port_helpers import port_block, random_init, t, to_numpy

torch.set_num_threads(1)

# (N, Cin, C, stride, residual): test_pallas_kernel.py:21-78
CASES = [
    (8, 64, 64, 1, True),      # identity residual
    (8, 64, 128, 2, True),     # projection residual + temporal stride
    (8, 3, 64, 1, False),      # first block: no residual
    (6, 16, 16, 1, True),      # N=6 under a 4-sample tile in the JAX kernel
]
IDS = ["identity", "proj_s2", "cin3_none", "n6_tile4"]


def _setup(rng, n, cin, cout, stride, residual, zero_res_bias):
    x = rng.normal(size=(n, 30, 14, cin)).astype(np.float32)
    A = build_adjacency("coco_cut", "spatial").astype(np.float32)
    A = A * (1 + 0.2 * rng.normal(size=A.shape)).astype(np.float32)
    block = JaxBlock(features=cout, stride=stride, residual=residual)
    v = random_init(block, rng, jnp.asarray(x), jnp.asarray(A), train=True)
    if zero_res_bias and "res_proj" in v["params"]:
        v["params"]["res_proj"]["bias"] = np.zeros_like(v["params"]["res_proj"]["bias"])
    return x, A, block, v


@pytest.mark.parametrize("n,cin,cout,stride,residual", CASES, ids=IDS)
def test_fold_matches_jax_fold(rng, n, cin, cout, stride, residual):
    x, A, _, v = _setup(rng, n, cin, cout, stride, residual, zero_res_bias=True)
    ref, _ = jk.fold_block_params(v["params"], v["batch_stats"], jnp.asarray(A))
    ours, mode = fold_block_params(port_block(v, cin, cout, stride, residual), t(A))
    assert mode == ("proj" if residual and cin != cout else
                    "identity" if residual else "none")
    for name in FoldedBlockParams._fields:
        theirs, mine = getattr(ref, name), getattr(ours, name)
        if mode != "proj" and name.startswith("res_"):
            assert mine is None
            continue
        np.testing.assert_allclose(to_numpy(mine), np.asarray(theirs), atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("n,cin,cout,stride,residual", CASES, ids=IDS)
def test_reference_matches_flax_block(rng, n, cin, cout, stride, residual):
    x, A, block, v = _setup(rng, n, cin, cout, stride, residual, zero_res_bias=False)
    ref = block.apply(v, jnp.asarray(x), jnp.asarray(A), train=False)
    folded, mode = fold_block_params(port_block(v, cin, cout, stride, residual), t(A))
    ours = stgcan_block_reference(t(x), folded, stride, mode)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(to_numpy(ours), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("n,cin,cout,stride,residual", CASES, ids=IDS)
def test_reference_matches_jax_kernel(rng, n, cin, cout, stride, residual):
    x, A, _, v = _setup(rng, n, cin, cout, stride, residual, zero_res_bias=True)
    jf, _ = jk.fold_block_params(v["params"], v["batch_stats"], jnp.asarray(A))
    folded, mode = fold_block_params(port_block(v, cin, cout, stride, residual), t(A))
    ref = jk.fused_stgcan_block(jnp.asarray(x), jf, stride=stride, residual_mode=mode,
                                samples_per_program=4, interpret=True)
    ours = stgcan_block_reference(t(x), folded, stride, mode)
    np.testing.assert_allclose(to_numpy(ours), np.asarray(ref), atol=2e-5)


def _small(rng):
    x, A, _, v = _setup(rng, 3, 16, 32, 2, True, zero_res_bias=False)
    folded, mode = fold_block_params(port_block(v, 16, 32, 2, True), t(A))
    return t(x), folded, mode


def test_wrapper_on_cpu_takes_the_plain_path(rng):
    x, folded, mode = _small(rng)
    before = fused_stgcan_block.launches
    out = fused_stgcan_block(x, pack_block(folded, mode, "cpu"), stride=2)
    assert fused_stgcan_block.launches == before == 0
    torch.testing.assert_close(out, stgcan_block_reference(x, folded, 2, mode),
                               rtol=0, atol=0)


def test_wrapper_refuses_bad_inputs(rng):
    x, folded, mode = _small(rng)
    packed = pack_block(folded, mode, "cpu")
    with pytest.raises(ValueError, match="contiguous float32"):
        fused_stgcan_block(x.transpose(1, 2), packed, stride=2)
    with pytest.raises(ValueError, match="contiguous float32"):
        fused_stgcan_block(x.double(), packed, stride=2)
    with pytest.raises(ValueError, match="stride must be 1 or 2"):
        fused_stgcan_block(x, packed, stride=3)
    with pytest.raises(ValueError, match="residual_mode"):    # refused where it is packed
        pack_block(folded, "sum", "cpu")
