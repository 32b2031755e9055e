"""The port's kernels on the CPU: each plain PyTorch version against the
JAX oracle (``repro/kernels/*/ref.py``) and the Pallas kernel run in
interpret mode, on the same inputs; and the wrappers' device rules. The
CUDA kernels themselves are tested on the card in test_torch_gpu.py."""
import jax.numpy as jnp
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
from repro.kernels.ssd import ref as jax_ssd
from repro.kernels.ssd.kernel import ssd_pallas
from repro_torch.kernels import launch_counts
from repro_torch.kernels.decode_attention.kernel import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_plain
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_plain
from repro_torch.kernels.rmsnorm.kernel import fused_residual_rmsnorm
from repro_torch.kernels.rmsnorm.ref import fused_residual_rmsnorm_plain
from repro_torch.kernels.ssd.kernel import ssd
from repro_torch.kernels.ssd.ref import (ssd_chunked, ssd_decode_step,
                                         ssd_sequential)
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


def _ssd_inputs(seed, b, s, h, p, n, dtype="float32"):
    """x, B, C normal (rounded to bf16 when asked); dt = softplus(normal)
    and A = -exp(normal), float32, as tests/test_kernels.py draws them."""
    (jx, jb, jc), (tx, tb, tc) = arrays(seed, (b, s, h, p), (b, s, h, n),
                                        (b, s, h, n), dtype=dtype)
    rng = np.random.default_rng(seed + 100)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    return ((jx, jnp.asarray(dt), jnp.asarray(a), jb, jc),
            (tx, torch.from_numpy(dt), torch.from_numpy(a), tb, tc))


def _ssd_tol(dtype, want_y):
    # tests/test_kernels.py: bf16 tolerance scales with |y| (the sum over N)
    if dtype == "bfloat16":
        return dict(rtol=4e-2,
                    atol=4e-2 + 0.02 * np.abs(np.asarray(want_y,
                                                         np.float32)).max())
    return dict(rtol=2e-4, atol=2e-4)


STATE_TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 64, 4, 32, 16, 16),        # four chunks
    (1, 40, 2, 16, 16, 16),        # ragged: 40 = 2 chunks + 8
    (1, 256, 2, 64, 128, 64),      # mamba2-370m head geometry
])
def test_ssd_plain_versions_match_jax(dtype, b, s, h, p, n, chunk):
    """The port's ssd_chunked and ssd_sequential against the JAX oracles
    and the Pallas kernel in interpret mode, on the same inputs."""
    jin, tin = _ssd_inputs(0, b, s, h, p, n, dtype)
    want_y, want_state = jax_ssd.ssd_sequential(*jin)
    tol = _ssd_tol(dtype, want_y)
    for y, state in (ssd_chunked(*tin, chunk=chunk), ssd_sequential(*tin)):
        assert y.dtype == tin[0].dtype and state.dtype == torch.float32
        close(y, want_y, tol)
        close(state, want_state, STATE_TOL)
    y, state = ssd_chunked(*tin, chunk=chunk)
    for want in (jax_ssd.ssd_chunked(*jin, chunk=chunk),
                 ssd_pallas(*jin, chunk=chunk, interpret=True)):
        close(y, want[0], tol)
        close(state, want[1], STATE_TOL)


def test_ssd_chunked_carries_an_initial_state_as_jax():
    jin, tin = _ssd_inputs(1, 1, 48, 2, 16, 16)
    init = np.random.default_rng(2).standard_normal(
        (1, 2, 16, 16)).astype(np.float32)
    want = jax_ssd.ssd_chunked(*jin, chunk=16, initial_state=jnp.asarray(init))
    got = ssd_chunked(*tin, chunk=16, initial_state=torch.from_numpy(init))
    close(got[0], want[0], _ssd_tol("float32", want[0]))
    close(got[1], want[1], STATE_TOL)
    seq = ssd_sequential(*tin, initial_state=torch.from_numpy(init))
    close(seq[1], want[1], STATE_TOL)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_decode_step_matches_jax_and_continues_the_scan(dtype):
    jin, tin = _ssd_inputs(3, 2, 9, 4, 16, 16, dtype)
    jx, jdt, ja, jb, jc = jin
    tx, tdt, ta, tb, tc = tin
    _, jstate = jax_ssd.ssd_sequential(jx[:, :8], jdt[:, :8], ja, jb[:, :8],
                                       jc[:, :8])
    _, tstate = ssd_sequential(tx[:, :8], tdt[:, :8], ta, tb[:, :8],
                               tc[:, :8])
    want = jax_ssd.ssd_decode_step(jstate, jx[:, 8], jdt[:, 8], ja,
                                   jb[:, 8], jc[:, 8])
    got = ssd_decode_step(tstate, tx[:, 8], tdt[:, 8], ta, tb[:, 8],
                          tc[:, 8])
    close(got[0], want[0], _ssd_tol(dtype, want[0]))
    close(got[1], want[1], STATE_TOL)
    # the step is the scan's last step
    y_all, state_all = ssd_sequential(*tin)
    close(got[0], y_all[:, 8].float().numpy(), _ssd_tol(dtype, want[0]))
    close(got[1], state_all.numpy(), STATE_TOL)


def test_ssd_chunking_does_not_change_the_result():
    """The CUDA kernel walks sub-chunks of its own size: the identity it
    rests on, on the plain version (tests/test_kernels.py proves it for
    the JAX package)."""
    _, tin = _ssd_inputs(4, 1, 96, 2, 16, 16)
    y1, s1 = ssd_chunked(*tin, chunk=96)
    for chunk in (16, 32, 40):
        y2, s2 = ssd_chunked(*tin, chunk=chunk)
        np.testing.assert_allclose(y2.numpy(), y1.numpy(), rtol=5e-4,
                                   atol=5e-4)
        np.testing.assert_allclose(s2.numpy(), s1.numpy(), rtol=5e-4,
                                   atol=5e-4)


def test_ssd_reads_a_group_broadcast_view_as_the_repeated_tensor():
    """The model passes B/C of one group as an expand view (head stride 0);
    the plain version gives the same result as on the materialised repeat
    of jnp.repeat."""
    _, (x, dt, a, b, c) = _ssd_inputs(5, 2, 20, 4, 16, 16)
    b1, c1 = b[:, :, :1], c[:, :, :1]
    view = (b1.expand(2, 20, 4, 16), c1.expand(2, 20, 4, 16))
    assert view[0].stride(2) == 0
    got = ssd(x, dt, a, *view, chunk=8)
    want = ssd(x, dt, a, b1.repeat(1, 1, 4, 1), c1.repeat(1, 1, 4, 1),
               chunk=8)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


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
    _, sin = _ssd_inputs(6, 1, 20, 2, 16, 16)
    assert all(torch.equal(a, b) for a, b in zip(ssd(*sin, chunk=8),
                                                 ssd_chunked(*sin, chunk=8)))
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
    with pytest.raises(ValueError, match="unsupported device"):
        ssd(q, q[..., 0], q[0, :, 0, 0], q, q)


def test_plain_decode_at_last_position_equals_full_attention_row():
    """Self-consistency of the two plain versions: decoding the last token
    against its own prefix is the last row of causal attention."""
    _, (q, k, v) = arrays(6, (2, 4, 24, 16), (2, 2, 24, 16), (2, 2, 24, 16))
    full = attention_plain(q, k, v, causal=True)
    last = decode_plain(q[:, :, -1:], k, v, torch.tensor([23]))
    np.testing.assert_allclose(last.numpy(), full[:, :, -1:].numpy(),
                               rtol=2e-5, atol=2e-5)
