"""The port's kernels on the CPU: each plain PyTorch version against the
JAX oracle (``repro/kernels/*/ref.py``) and the Pallas kernel run in
interpret mode, on the same inputs; and the wrappers' device rules. The
CUDA kernels themselves are tested on the card in test_torch_gpu.py."""
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import \
    decode_attention as pallas_decode
from repro.kernels.decode_attention.ref import decode_reference
from repro.kernels.flash_attention.kernel import \
    flash_attention as pallas_flash
from repro.kernels.flash_attention.ref import attention_reference
from repro.kernels.rmsnorm.kernel import \
    fused_residual_rmsnorm as pallas_rmsnorm
from repro.kernels.rmsnorm.ref import fused_residual_rmsnorm_reference
from repro_torch.kernels import launch_counts
from repro_torch.kernels.decode_attention.kernel import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_plain
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_plain
from repro_torch.kernels.rmsnorm.kernel import fused_residual_rmsnorm
from repro_torch.kernels.rmsnorm.ref import fused_residual_rmsnorm_plain
from torch_parity import DTYPES, arrays, close


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("residual", [True, False])
def test_rmsnorm_plain_matches_jax(dtype, residual):
    tol = DTYPES[dtype][2]
    (jx, jr, js), (tx, tr, ts) = arrays(0, (16, 64), (16, 64), (64,),
                                        dtype=dtype)
    if not residual:                      # JAX takes a residual: give zeros
        jr = jr * 0
    y, h = fused_residual_rmsnorm_plain(tx, tr if residual else None, ts)
    for want in (fused_residual_rmsnorm_reference(jx, jr, js),
                 pallas_rmsnorm(jx, jr, js, block_rows=8, interpret=True)):
        close(y, want[0], tol)
        close(h, want[1], tol)
    assert y.dtype == tx.dtype and h.dtype == tx.dtype


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,hq,hkv,s,d,window", [
    (1, 4, 2, 64, 16, 0),        # GQA 2:1, the reduced config's head dim
    (2, 4, 4, 64, 32, 0),        # MHA
    (1, 4, 1, 64, 16, 16),       # MQA, sliding window
])
def test_flash_plain_matches_jax(dtype, b, hq, hkv, s, d, window):
    tol = DTYPES[dtype][2]
    (jq, jk, jv), (tq, tk, tv) = arrays(1, (b, hq, s, d), (b, hkv, s, d),
                                        (b, hkv, s, d), dtype=dtype)
    got = attention_plain(tq, tk, tv, causal=True, window=window)
    close(got, attention_reference(jq, jk, jv, causal=True, window=window),
          tol)
    close(got, pallas_flash(jq, jk, jv, causal=True, window=window, bq=32,
                            bk=32, interpret=True), tol)


def test_flash_plain_ragged_length_matches_jax_reference():
    """Lengths that are no block multiple (the TPU kernel asserts them)."""
    tol = DTYPES["float32"][2]
    (jq, jk, jv), (tq, tk, tv) = arrays(2, (2, 4, 50, 16), (2, 2, 50, 16),
                                        (2, 2, 50, 16))
    close(attention_plain(tq, tk, tv), attention_reference(jq, jk, jv), tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("pos", [0, 31, 63])
def test_decode_plain_matches_jax(dtype, pos):
    """The port reads the model's (B,S,Hkv,d) cache as a transposed view;
    the JAX kernel takes (B,Hkv,S,d)."""
    tol = DTYPES[dtype][2]
    (jq, jk, jv), (tq, tk, tv) = arrays(3, (2, 4, 1, 16), (2, 2, 64, 16),
                                        (2, 2, 64, 16), dtype=dtype)
    tk_view = tk.transpose(1, 2).contiguous().transpose(1, 2)
    tv_view = tv.transpose(1, 2).contiguous().transpose(1, 2)
    got = decode_plain(tq, tk_view, tv_view,
                       torch.tensor([pos], dtype=torch.int32))
    close(got, decode_reference(jq, jk, jv, pos), tol)
    close(got, pallas_decode(jq, jk, jv, pos, bk=32, interpret=True), tol)


def test_wrappers_take_the_plain_version_on_cpu_and_count_no_launch():
    before = launch_counts()
    _, (x, r, s) = arrays(4, (8, 64), (8, 64), (64,))
    assert all(torch.equal(a, b) for a, b in zip(
        fused_residual_rmsnorm(x, r, s), fused_residual_rmsnorm_plain(x, r, s)))
    _, (q, k, v) = arrays(5, (1, 4, 20, 16), (1, 2, 20, 16), (1, 2, 20, 16))
    assert torch.equal(flash_attention(q, k, v), attention_plain(q, k, v))
    pos = torch.tensor([7], dtype=torch.int32)
    assert torch.equal(decode_attention(q[:, :, :1], k, v, pos),
                       decode_plain(q[:, :, :1], k, v, pos))
    assert launch_counts() == before


def test_wrappers_refuse_other_devices():
    x = torch.empty((8, 64), device="meta")
    q = torch.empty((1, 4, 16, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_residual_rmsnorm(x, None, torch.empty(64, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention(q[:, :, :1], q, q,
                         torch.zeros(1, dtype=torch.int32, device="meta"))


def test_plain_decode_at_last_position_equals_full_attention_row():
    """Self-consistency of the two plain versions: decoding the last token
    against its own prefix is the last row of causal attention."""
    _, (q, k, v) = arrays(6, (2, 4, 24, 16), (2, 2, 24, 16), (2, 2, 24, 16))
    full = attention_plain(q, k, v, causal=True)
    last = decode_plain(q[:, :, -1:], k, v, torch.tensor([23]))
    np.testing.assert_allclose(last.numpy(), full[:, :, -1:].numpy(),
                               rtol=2e-5, atol=2e-5)
