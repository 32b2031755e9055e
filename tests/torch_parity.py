"""Helpers shared by the parity tests of the PyTorch port against the JAX
package: inputs made with numpy from a seed, the same values handed to both
frameworks, and the JAX params carried across by path."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from repro import configs as jax_configs
from repro.models import Model as JaxModel
from repro_torch import configs
from repro_torch.weights import params_from_jax

#: name -> (jax dtype, torch dtype, tolerance), as tests/test_kernels.py
DTYPES = {
    "float32": (jnp.float32, torch.float32, dict(rtol=2e-5, atol=2e-5)),
    "bfloat16": (jnp.bfloat16, torch.bfloat16, dict(rtol=2e-2, atol=2e-2)),
}


def arrays(seed: int, *shapes, dtype: str = "float32", scale: float = 1.0):
    """Normal float32 arrays from ``seed``, rounded to bf16 when ``dtype``
    is bfloat16 so both frameworks get exactly the same values. Returns
    (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    jdt, tdt, _ = DTYPES[dtype]
    js, ts = [], []
    for shape in shapes:
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        if dtype == "bfloat16":
            a = a.astype(ml_dtypes.bfloat16).astype(np.float32)
        js.append(jnp.asarray(a, jdt))
        ts.append(torch.from_numpy(a).to(tdt))
    return js, ts


def close(got: torch.Tensor, want, tol: dict) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """JAX param tree -> {'layers/attn/wq': numpy array, ...}."""
    out: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def reduced_pair(dtype=jnp.float32, seed: int = 0):
    """The reduced tinyllama config in ``dtype`` on both sides, with the
    JAX ``Model.init`` params and the same params carried into the port.
    Returns (jax cfg, jax model, jax params, port cfg, port params)."""
    jcfg = dataclasses.replace(jax_configs.get_reduced("tinyllama-1.1b"),
                               dtype=dtype)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tcfg = dataclasses.replace(configs.get_reduced("tinyllama-1.1b"),
                               dtype=tdt)
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    return jcfg, jmodel, jparams, tcfg, params_from_jax(flatten(jparams))
