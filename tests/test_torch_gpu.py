"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA Hopper card and nvcc; without one each
skips. On the card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py -q

Imports only torch and the port (the card's machine has no JAX).
"""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.decode_attention.kernel import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_plain
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_plain
from repro_torch.kernels.rmsnorm.kernel import fused_residual_rmsnorm
from repro_torch.kernels.rmsnorm.ref import fused_residual_rmsnorm_plain
from repro_torch.kernels.ssd.kernel import ssd
from repro_torch.kernels.ssd.ref import ssd_chunked
from repro_torch.models import Model

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator("cuda").manual_seed(0)


def _randn(gen, *shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _close(got, want, dtype):
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d", [(8, 2048), (2048, 2048), (8, 1024),
                                    (2048, 1024), (3, 64), (5, 8192)])
@pytest.mark.parametrize("residual", [True, False])
def test_rmsnorm_kernel_matches_plain(gen, dtype, rows, d, residual):
    x = _randn(gen, rows, d, dtype=dtype)
    r = _randn(gen, rows, d, dtype=dtype) if residual else None
    s = _randn(gen, d, dtype=dtype)
    before = launch_counts()["fused_residual_rmsnorm"]
    y, h = fused_residual_rmsnorm(x, r, s)
    assert launch_counts()["fused_residual_rmsnorm"] == before + 1
    wy, wh = fused_residual_rmsnorm_plain(x, r, s)
    _close(y, wy, dtype)
    _close(h, wh, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,window", [
    (8, 32, 4, 256, 256, 64, 0),     # the serve path's prefill
    (2, 32, 4, 200, 200, 64, 0),     # ragged last tile
    (1, 4, 2, 16, 16, 16, 0),        # the reduced config, one partial tile
    (1, 4, 1, 190, 190, 128, 48),    # MQA, sliding window, d 128
    (2, 8, 8, 70, 130, 32, 0),       # Sq != Skv
])
def test_flash_kernel_matches_plain(gen, dtype, b, hq, hkv, sq, skv, d,
                                    window):
    # the model's (B,S,H,d) layout, passed as transposed views
    q = _randn(gen, b, sq, hq, d, dtype=dtype).transpose(1, 2)
    k = _randn(gen, b, skv, hkv, d, dtype=dtype).transpose(1, 2)
    v = _randn(gen, b, skv, hkv, d, dtype=dtype).transpose(1, 2)
    got = flash_attention(q, k, v, causal=True, window=window)
    assert got.stride() == q.stride()
    _close(got, attention_plain(q, k, v, causal=True, window=window), dtype)
    got = flash_attention(q, k, v, causal=False)
    _close(got, attention_plain(q, k, v, causal=False), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,pos", [(320, 0), (320, 160), (320, 319),
                                   (100, 63), (100, 64), (7, 3)])
def test_decode_kernel_matches_plain(gen, dtype, s, pos):
    b, hq, hkv, d = 8, 32, 4, 64
    q = _randn(gen, b, 1, hq, d, dtype=dtype).transpose(1, 2)
    kc = _randn(gen, b, s, hkv, d, dtype=dtype).transpose(1, 2)
    vc = _randn(gen, b, s, hkv, d, dtype=dtype).transpose(1, 2)
    p = torch.tensor([pos], dtype=torch.int32, device="cuda")
    _close(decode_attention(q, kc, vc, p), decode_plain(q, kc, vc, p), dtype)


def _ssd_inputs(gen, b, s, h, p, n, groups, dtype):
    """x, B, C normal; dt = softplus(normal), A = -exp(normal) in float32.
    One group passes B/C as the model does: an expand view, head stride 0."""
    x = _randn(gen, b, s, h, p, dtype=dtype)
    dt = torch.nn.functional.softplus(_randn(gen, b, s, h,
                                             dtype=torch.float32))
    a = -torch.exp(_randn(gen, h, dtype=torch.float32))
    bm = _randn(gen, b, s, groups, n, dtype=dtype)
    cm = _randn(gen, b, s, groups, n, dtype=dtype)
    if groups == 1:
        bm, cm = bm.expand(b, s, h, n), cm.expand(b, s, h, n)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [64, 200, 256, 1000, 1024])
@pytest.mark.parametrize("groups", ["one", "per_head"])
@pytest.mark.parametrize("n,p", [(128, 64), (16, 16)])
def test_ssd_kernel_matches_plain(gen, dtype, s, groups, n, p):
    """y and the final state against ssd_chunked at the model's chunk of
    256: one chunk, several, and ragged tails (200, 1000). Tolerances as
    tests/test_kernels.py's SSD sweep, with float32's atol scaled by max|y|
    as bf16's is: the two sum over N and the sequence in another order, and
    |y| reaches tens."""
    b, h = 2, 8
    x, dt, a, bm, cm = _ssd_inputs(gen, b, s, h, p, n,
                                   1 if groups == "one" else h, dtype)
    before = launch_counts()["ssd"]
    y, state = ssd(x, dt, a, bm, cm, chunk=256)
    assert launch_counts()["ssd"] == before + 1
    want_y, want_state = ssd_chunked(x, dt, a, bm, cm, chunk=256)
    torch.cuda.synchronize()
    assert y.shape == x.shape and y.dtype == dtype
    assert state.shape == (b, h, n, p) and state.dtype == torch.float32
    top = want_y.float().abs().max().item()
    tol = (dict(rtol=4e-2, atol=4e-2 + 0.02 * top)
           if dtype == torch.bfloat16
           else dict(rtol=2e-4, atol=2e-4 + 2e-5 * top))
    torch.testing.assert_close(y.float(), want_y.float(), **tol)
    torch.testing.assert_close(state, want_state, rtol=2e-3, atol=2e-3)


def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    x = _randn(gen, 4, 60, dtype=torch.bfloat16)      # 60 % 8 != 0
    with pytest.raises(ValueError):
        fused_residual_rmsnorm(x, None, _randn(gen, 60, dtype=torch.bfloat16))
    q = _randn(gen, 1, 4, 16, 48, dtype=torch.float32)  # d 48 not built
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):                    # pos must be int32
        decode_attention(q[:, :, :1], q, q,
                         torch.zeros(1, dtype=torch.int64, device="cuda"))
    x, dt, a, bm, cm = _ssd_inputs(gen, 1, 8, 2, 16, 16, 2, torch.float32)
    with pytest.raises(ValueError):                    # dt must be float32
        ssd(x, dt.bfloat16(), a, bm, cm)
    with pytest.raises(ValueError):                    # N = 48 not built
        ssd(x, dt, a, bm[..., :12].repeat(1, 1, 1, 4),
            cm[..., :12].repeat(1, 1, 1, 4))


def _to_cpu(tree):
    return {k: _to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


def test_model_kernel_path_matches_plain_path(gen):
    """The reduced model in float32: prefill and decode on the card through
    the kernels against the same params on the CPU through the plain
    versions, and every kernel launched."""
    cfg = dataclasses.replace(configs.get_reduced("tinyllama-1.1b"),
                              dtype=torch.float32)
    model = Model(cfg)
    params = model.init(gen, "cuda")
    cpu = _to_cpu(params)
    toks = torch.randint(0, 259, (2, 12), generator=gen, device="cuda",
                         dtype=torch.int32)
    reset_launch_counts()
    with torch.inference_mode():
        got, gc = model.prefill(params, toks, max_len=16)
        want, wc = model.prefill(cpu, toks.cpu(), max_len=16)
        _close(got.cpu(), want, torch.float32)
        for _ in range(4):
            tok = got.argmax(-1, keepdim=True).to(torch.int32)
            got, gc = model.decode_step(params, gc, tok)
            want, wc = model.decode_step(cpu, wc, tok.cpu())
            _close(got.cpu(), want, torch.float32)
    counts = launch_counts()
    assert counts == {"fused_residual_rmsnorm": 5 * 5,
                      "flash_attention": 2, "decode_attention": 2 * 4,
                      "ssd": 0}


def test_mamba_model_kernel_path_matches_plain_path(gen):
    """Reduced mamba2 in float32 at a ragged prompt (20 = chunk 16 + 4):
    prefill through the SSD kernel and decode on the card against the same
    params on the CPU through the plain versions."""
    cfg = dataclasses.replace(configs.get_reduced("mamba2-370m"),
                              dtype=torch.float32)
    model = Model(cfg)
    params = model.init(gen, "cuda")
    cpu = _to_cpu(params)
    toks = torch.randint(0, 259, (2, 20), generator=gen, device="cuda",
                         dtype=torch.int32)
    # the SSD kernel sums in sub-chunks of 32, the CPU's plain version in
    # chunks of 16: fp32 sums in another order, so the model tolerance of
    # the CPU parity tests
    tol = dict(rtol=1e-4, atol=1e-4)
    reset_launch_counts()
    with torch.inference_mode():
        got, gc = model.prefill(params, toks, max_len=24)
        want, wc = model.prefill(cpu, toks.cpu(), max_len=24)
        torch.testing.assert_close(got.cpu(), want, **tol)
        torch.testing.assert_close(gc["layers"]["ssm"].cpu(),
                                   wc["layers"]["ssm"], **tol)
        for _ in range(4):
            tok = got.argmax(-1, keepdim=True).to(torch.int32)
            got, gc = model.decode_step(params, gc, tok)
            want, wc = model.decode_step(cpu, wc, tok.cpu())
            torch.testing.assert_close(got.cpu(), want, **tol)
    # 2L+1 norms per forward (the block norm fused with the residual, and
    # each layer's gated norm), 5 forwards; one SSD launch per layer in
    # prefill; decode runs the plain one-step recurrence
    assert launch_counts() == {"fused_residual_rmsnorm": 5 * 5,
                               "flash_attention": 0, "decode_attention": 0,
                               "ssd": 2}
