"""DiffTS (soft top-k token selection) and DMTP (gated multi-scale pooling)
of the port's μ²tokenizer against the JAX package's.

The ops on the same seeded inputs, the two modules and the whole
μ²tokenizer with either or both switched on, with the JAX modules'
parameters carried over by ``load_flax_params``; fp32 on the CPU, sums in
different orders: 1e-5. DMTP's gate is not a ``Dense``: its (E, 1)
kernel and (1,) bias keep flax's names and layout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from u2tokenizer_torch.config import U2TokenizerConfig as TU2tCfg
from u2tokenizer_torch.models.u2tok import svr as t_svr
from u2tokenizer_torch.models.u2tok.u2tokenizer import \
    U2Tokenizer as TU2Tokenizer
from u2tokenizer_torch.ops import pooling as t_pool
from u2tokenizer_torch.ops import topk as t_topk
from u2tokenizer_torch.weights import load_flax_params, torch_name
from u2tokenizer_tpu.config import U2ModelConfig as JCfg
from u2tokenizer_tpu.models.u2tok import svr as j_svr
from u2tokenizer_tpu.models.u2tok.u2tokenizer import \
    U2Tokenizer as JU2Tokenizer
from u2tokenizer_tpu.ops import pooling as j_pool
from u2tokenizer_tpu.ops import topk as j_topk

pytestmark = pytest.mark.fast

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _flat(params):
    return {k: np.array(v) for k, v in
            traverse_util.flatten_dict(params["params"], sep="/").items()}


@pytest.mark.parametrize("tau", [1.0, 0.3])
def test_soft_topk_select(tau):
    x, scores = _rand((2, 13, 8), 0), _rand((2, 13, 5), 1)
    ref = j_topk.soft_topk_select(jnp.asarray(x), jnp.asarray(scores), tau)
    out = t_topk.soft_topk_select(torch.from_numpy(x),
                                  torch.from_numpy(scores), tau)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("s,scales", [(16, (1, 2, 4)), (6, (1, 2, 4, 8)),
                                      (9, (1, 3))])
def test_dynamic_multi_scale_pool(s, scales):
    x, kernel, bias = _rand((2, s, 8), 2), _rand((8, 1), 3), _rand((1,), 4)
    ref = j_pool.dynamic_multi_scale_pool(
        jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias), scales)
    out = t_pool.dynamic_multi_scale_pool(
        torch.from_numpy(x), torch.from_numpy(kernel),
        torch.from_numpy(bias), scales)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("module", ["diffts", "dmtp"])
def test_modules(module):
    e, k = 16, 6
    if module == "diffts":
        x = _rand((2, 3, 5, e), 5)
        jm = j_svr.DifferentiableTokenSelection(e, k, tau=0.7)
        tm = t_svr.DifferentiableTokenSelection(e, k, tau=0.7)
    else:
        x = _rand((2, 12, e), 6)
        jm = j_svr.DynamicMultiScalePooling(e, (1, 2, 4))
        tm = t_svr.DynamicMultiScalePooling(e, (1, 2, 4))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    flat = _flat(params)
    if module == "dmtp":  # a bias that is not zero
        flat["gate_bias"] = np.array([0.3], np.float32)
        params = {"params": {**params["params"], "gate_bias":
                             jnp.asarray(flat["gate_bias"])}}
        modules = dict(tm.named_modules())
        assert torch_name("gate_kernel", modules) == ("gate_kernel", False)
    load_flax_params(tm, flat)
    ref = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("diffts,dmtp", [(True, True), (True, False),
                                         (False, True)])
def test_u2tokenizer(diffts, dmtp):
    """The whole μ²tokenizer (SVR with DiffTS and/or DMTP, then TTA) of the
    tiny config, with all the JAX module's parameters loaded."""
    jcfg = dataclasses.replace(JCfg.tiny().u2t, enable_diffts=diffts,
                               enable_dmtp=dmtp, diffts_tau=0.5)
    tcfg = TU2tCfg(**dataclasses.asdict(jcfg))
    v, t = _rand((2, 2, 8, 128), 7), _rand((2, 6, 128), 8)
    jm = JU2Tokenizer(128, jcfg)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(v), jnp.asarray(t))
    tm = TU2Tokenizer(128, tcfg)
    load_flax_params(tm, _flat(params))
    svt = tm.svt_module
    assert isinstance(svt.token_selection, t_svr.DifferentiableTokenSelection
                      if diffts else t_svr.TokenSelection)
    assert hasattr(svt, "dynamic_pool") == dmtp
    ref = jm.apply(params, jnp.asarray(v), jnp.asarray(t))
    with torch.no_grad():
        out = tm(torch.from_numpy(v), torch.from_numpy(t))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
