"""The gather wrapper takes int32 and int64 indices as they are: both give
the same bits, equal to the JAX package's Pallas gather in interpret mode,
and the same f32 scatter-add gradient.  On the CPU the wrapper runs the
plain version; the tables are the main path's row widths: 12-byte f32 xyz
rows, 512-byte f32 rows and 256-byte bf16 rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prifit_torch.kernels.gather import gather_rows
from prifit_tpu.ops.pallas.gather import gather_rows_pallas

torch.set_num_threads(1)

B, N = 2, 128
TABLES = [(3, torch.float32), (128, torch.float32), (128, torch.bfloat16)]


def _inputs(seed, C, dtype, shape=(40, 3)):
    rng = np.random.default_rng(seed)
    tab = torch.from_numpy(rng.normal(size=(B, N, C)).astype(np.float32))
    idx = rng.integers(0, N, size=(B,) + shape)
    return tab.to(dtype), idx


@pytest.mark.parametrize("C,dtype", TABLES)
def test_index_types_bit_equal(C, dtype):
    tab, idx = _inputs(0, C, dtype)
    out32 = gather_rows(tab, torch.from_numpy(idx.astype(np.int32)))
    out64 = gather_rows(tab, torch.from_numpy(idx.astype(np.int64)))
    assert out32.shape == (B, 40, 3, C) and out32.dtype == dtype
    assert torch.equal(out32.view(torch.uint8), out64.view(torch.uint8))


@pytest.mark.parametrize("C,dtype", TABLES)
def test_index_types_match_pallas(C, dtype):
    """The Pallas gather moves f32 rows; a bf16 table goes through it
    widened to f32, which is exact, and is compared after narrowing."""
    tab, idx = _inputs(1, C, dtype, shape=(300,))
    ref = gather_rows_pallas(jnp.asarray(tab.float().numpy()),
                             jnp.asarray(idx.astype(np.int32)),
                             interpret=True)
    ref = torch.from_numpy(np.array(ref)).to(dtype)
    for itype in (np.int32, np.int64):
        out = gather_rows(tab, torch.from_numpy(idx.astype(itype)))
        assert torch.equal(out.view(torch.uint8), ref.view(torch.uint8))


@pytest.mark.parametrize("C,dtype", TABLES)
def test_index_types_same_gradient(C, dtype):
    """The backward of both is the f32 scatter-add: repeated indices sum
    into their row, rows never gathered get zeros."""
    tab, idx = _inputs(2, C, dtype)
    g = torch.from_numpy(np.random.default_rng(3).normal(
        size=(B, 40, 3, C)).astype(np.float32)).to(dtype)
    grads = []
    for itype in (np.int32, np.int64):
        t = tab.clone().requires_grad_()
        gather_rows(t, torch.from_numpy(idx.astype(itype))).backward(g)
        grads.append(t.grad)
    ref = torch.zeros((B, N, C))
    for b in range(B):
        ref[b].index_add_(0, torch.from_numpy(idx[b].reshape(-1)),
                          g[b].reshape(-1, C).float())
    ref = ref.to(dtype)
    for grad in grads:
        assert grad.dtype == dtype
        assert torch.equal(grad.view(torch.uint8), ref.view(torch.uint8))
