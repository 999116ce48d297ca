"""Port parity: the decoder's ``torch.export`` program (utils/export.py).

The JAX decoder (hidden 32, 2 layers, every parameter perturbed) is carried
across with the weight bridge.  The dynamic ``.pt2`` (batch, mel length and
context length symbolic, the lengths bounded by the positional tables) is
held to the port's eager decoder at 1e-6 (the same ops on the same CPU) and
to the JAX decoder called directly at 1e-5 (float32 on both sides, other
summation orders); the static ``.pt2`` at (1, 200, 100) to the JAX
package's own static StableHLO export of the same weights at 1e-5.  JAX's
dynamic export fails to trace (ROADMAP Queue C item 5), so it is not a
reference here.  A length past a positional table is refused at the call.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edge_diffusion_tts_tpu.config import CFG as JCFG
from edge_diffusion_tts_tpu.models import EdgeDiffusionDecoder as JDecoder
from edge_diffusion_tts_tpu.models.decoder import init_decoder_params
from edge_diffusion_tts_tpu.utils import export as jexport
from edge_diffusion_tts_tpu_torch.config import CFG as PCFG
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder as PDecoder
from edge_diffusion_tts_tpu_torch.utils.export import export_for_edge, load_exported
from edge_diffusion_tts_tpu_torch.weights import state_dict_from_jax
from test_torch_orbax_bridge import _jitter

SMALL = dict(hidden=32, layers=2, heads=2, dropout=0.0, attn_window_size=8)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the small calls here are launch-bound, and the
    other test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    jcfg = JCFG(**SMALL)
    jdec = JDecoder(jcfg)
    params = _jitter(jax.jit(
        lambda: init_decoder_params(jdec, jax.random.PRNGKey(0), jcfg)["params"])(), 5)
    cfg = PCFG(**SMALL)
    pdec = PDecoder(cfg)
    pdec.load_state_dict(state_dict_from_jax(params, cfg))
    tmp = tmp_path_factory.mktemp("export")
    dynamic = export_for_edge(cfg, pdec, str(tmp / "dec.pt2"))
    static = export_for_edge(cfg, pdec, str(tmp / "static.pt2"), dynamic=False)
    return dict(cfg=cfg, jdec=jdec, params=params, pdec=pdec.eval(), tmp=tmp,
                dynamic=load_exported(dynamic, device="cpu"),
                static=load_exported(static, device="cpu"))


def _inputs(B, T, S, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, 80).astype(np.float32), rng.randint(0, 1000, B),
            rng.randint(0, 2304, (B, S)), rng.randint(0, 20, B))


def _run_port(fn, inputs):
    x, t, s, st = (torch.from_numpy(np.asarray(a)) for a in inputs)
    with torch.no_grad():
        return fn(x, t.long(), s.long(), st.long()).numpy()


def _run_jax(models, inputs):
    x, t, s, st = (jnp.asarray(a) for a in inputs)
    apply = jax.jit(lambda p, x, t, s, st: models["jdec"].apply(
        {"params": p}, x, t, sem_idx=s, step_idx=st))
    return np.asarray(apply(models["params"], x, t.astype(jnp.int32), s.astype(jnp.int32),
                            st.astype(jnp.int32)))


@pytest.mark.parametrize("shape", [(1, 37, 19), (2, 500, 250), (3, 1000, 512), (1, 1, 1)])
def test_dynamic_pt2_equals_eager_and_jax(models, shape):
    inputs = _inputs(*shape)
    got = _run_port(models["dynamic"], inputs)
    eager = _run_port(lambda x, t, s, st: models["pdec"](x, t, sem_idx=s, step_idx=st), inputs)
    assert got.shape == shape[:2] + (80,)
    np.testing.assert_allclose(got, eager, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, _run_jax(models, inputs), atol=1e-5, rtol=0)


def test_static_pt2_equals_jax_static_export(models):
    path = os.path.join(str(models["tmp"]), "dec.stablehlo")
    jexport.export_for_edge(JCFG(**SMALL), models["jdec"], models["params"], path,
                            dynamic=False)
    inputs = _inputs(1, 200, 100, seed=3)  # JAX's static shape
    x, t, s, st = (jnp.asarray(a) for a in inputs)
    want = np.asarray(jexport.load_exported(path).call(
        models["params"], x, t.astype(jnp.int32), s.astype(jnp.int32), st.astype(jnp.int32)))
    got = _run_port(models["static"], inputs)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # The static program takes (1, 200, 100) only.
    with pytest.raises(Exception, match="200|size|shape"):
        _run_port(models["static"], _inputs(1, 201, 100))


@pytest.mark.parametrize("T,S", [(1001, 10), (10, 513)])
def test_past_the_positional_tables_is_refused(models, T, S):
    with pytest.raises(Exception, match="1000|512"):
        _run_port(models["dynamic"], _inputs(1, T, S))
