"""Port parity at bfloat16 compute: the fused DDIM/DDPM loops and the band
kernel's plain version against the JAX package, on the CPU.

On CPU tensors ``fused_generate_mel``/``fused_ddpm_sample`` at
``compute_dtype=torch.bfloat16`` run their plain versions, which round where
the TPU kernels' bf16 ``mm`` rounds (both operands of every product, the
sums in float32).  bf16 rounds at other points in the two frameworks, so a
bf16 result Q is held by the witness rule against JAX's float32 result Q32
on the same weights, inputs and draws, normwise:

    |Q_port - Q32| / |Q32| <= 1.5 * |Q_jax - Q32| / |Q32| + 1e-3

with Q_jax JAX's bf16 result: its Pallas kernel in interpret mode for DDIM
without the pre-net (4 eps steps and 2 v steps: after one eps step every x0
is clipped at t=999 and bf16 shows nowhere) and for DDPM with injected
noise over an 8-step schedule; JAX's XLA ``ddim_sample`` over
``EdgeDiffusionDecoder(dtype=bfloat16)`` for the loop with the depthwise
pre-net (JAX's kernel leaves it out, ROADMAP Queue C 1), at an odd T.  The
bf16 DDPM AdaLN table is held to JAX's fold-then-round (the kernel's
in-loop ``mm`` on its host-side fold) at 1e-6; the band route's plain
version on bf16 q, k, v to JAX's ``banded_attention`` in interpret mode
within one bf16 ulp of the output.  The float32 plain outputs equal the
float32 path as it was before the bf16 variant, bit for bit (a frozen copy
of that path below).  Small config: hidden 32, 2 layers, 2 heads, window 8,
B=2, S=12; JAX's results are computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from edge_diffusion_tts_tpu.config import CFG as JCFG
from edge_diffusion_tts_tpu.models import EdgeDiffusionDecoder as JDecoder
from edge_diffusion_tts_tpu.models.decoder import init_decoder_params
from edge_diffusion_tts_tpu.ops.fused_denoise import _time_cond as j_time_cond
from edge_diffusion_tts_tpu.ops.fused_denoise import fused_ddpm_sample as j_ddpm
from edge_diffusion_tts_tpu.ops.fused_denoise import fused_generate_mel as j_ddim
from edge_diffusion_tts_tpu.ops.window_attention import banded_attention as j_band
from edge_diffusion_tts_tpu.schedule import DiffusionSchedule as JSchedule
from edge_diffusion_tts_tpu.schedule import ddim_sample as j_ddim_sample
from edge_diffusion_tts_tpu_torch.config import CFG as PCFG
from edge_diffusion_tts_tpu_torch.layers.attention import sdpa
from edge_diffusion_tts_tpu_torch.layers.ffn import swiglu
from edge_diffusion_tts_tpu_torch.models import EdgeDiffusionDecoder as PDecoder
from edge_diffusion_tts_tpu_torch.ops import fused_denoise as pf
from edge_diffusion_tts_tpu_torch.ops import window_attention as wa
from edge_diffusion_tts_tpu_torch.schedule import DiffusionSchedule as PSchedule
from edge_diffusion_tts_tpu_torch.weights import state_dict_from_jax

BF16 = torch.bfloat16
SMALL = dict(hidden=32, layers=2, heads=2, dropout=0.0, attn_window_size=8)
FACTOR, SLACK = 1.5, 1e-3  # the witness rule
B, S = 2, 12
DDPM_STEPS = 8


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def witness(what: str, port, jax_bf16, jax_f32) -> None:
    """The witness rule; prints the three distances (``pytest -s``)."""
    e_port, e_jax = rel(port, jax_f32), rel(jax_bf16, jax_f32)
    print(f"{what}: port bf16 {e_port:.3g} from JAX float32, JAX bf16 {e_jax:.3g}, port vs "
          f"JAX bf16 {rel(port, jax_bf16):.3g}")
    assert e_port <= FACTOR * e_jax + SLACK, (
        f"{what}: port bf16 is {e_port:.3g} from JAX float32, JAX bf16 {e_jax:.3g}")


class Pair:
    """One small config in both packages on the same perturbed weights."""

    def __init__(self, **kw):
        self.jcfg, self.pcfg = JCFG(**SMALL, **kw), PCFG(**SMALL, **kw)
        params = init_decoder_params(JDecoder(self.jcfg), jax.random.PRNGKey(0),
                                     self.jcfg)["params"]
        leaves, tree = jax.tree.flatten(params)
        keys = jax.random.split(jax.random.PRNGKey(5), len(leaves))
        self.params = jax.tree.unflatten(
            tree, [p + 0.02 * jax.random.normal(k, p.shape) for p, k in zip(leaves, keys)])
        self.pdec = PDecoder(self.pcfg)
        self.pdec.load_state_dict(state_dict_from_jax(self.params, self.pcfg))
        self.pdec.eval()
        self.cache = {}

    def jax(self, key, fn):
        """JAX's result for ``key``, computed once."""
        if key not in self.cache:
            self.cache[key] = np.asarray(fn())
        return self.cache[key]


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.fixture(scope="module")
def prenet_pair():
    return Pair(use_depthwise=True)


def _inputs(T=2 * S, seed=1):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 2304, size=(B, S)), rng.randn(B, T, 80).astype(np.float32)


@pytest.mark.parametrize("steps,prediction", [(4, "eps"), (2, "v")])
def test_fused_generate_mel_bf16_witness_vs_jax_kernel(pair, steps, prediction):
    sem_idx, x_T = _inputs()
    jsched = JSchedule.create(pair.jcfg.diff_steps)
    want = {dt: pair.jax(("ddim", steps, prediction, dt), lambda dt=dt: j_ddim(
        pair.jcfg, jsched, pair.params, sem_idx, x_T, steps, prediction, interpret=True,
        compute_dtype=dt)) for dt in (jnp.float32, jnp.bfloat16)}
    sched = PSchedule.create(pair.pcfg.diff_steps)
    before = pf.fused_ddim.launches, pf.fused_ddim.bf16_launches
    got = {dt: pf.fused_generate_mel(pair.pcfg, sched, pair.pdec, torch.from_numpy(sem_idx),
                                     torch.from_numpy(x_T), steps, prediction,
                                     compute_dtype=dt) for dt in (torch.float32, BF16)}
    assert (pf.fused_ddim.launches, pf.fused_ddim.bf16_launches) == before  # CPU: plain
    assert got[BF16].dtype == torch.float32 and not torch.equal(got[BF16], got[torch.float32])
    witness(f"DDIM {steps} {prediction}", got[BF16].numpy(), want[jnp.bfloat16],
            want[jnp.float32])


def test_fused_ddpm_sample_bf16_witness_vs_jax_kernel(pair):
    sem_idx, x_T = _inputs(seed=11)
    noise = np.random.RandomState(12).randn(B, DDPM_STEPS, 2 * S, 80).astype(np.float32)
    jsched = JSchedule.create(DDPM_STEPS)
    want = {dt: pair.jax(("ddpm", dt), lambda dt=dt: j_ddpm(
        pair.jcfg, jsched, pair.params, sem_idx, x_T, noise=noise, interpret=True,
        compute_dtype=dt)) for dt in (jnp.float32, jnp.bfloat16)}
    before = pf.fused_ddpm.launches, pf.fused_ddpm.bf16_launches
    got = pf.fused_ddpm_sample(pair.pcfg, PSchedule.create(DDPM_STEPS), pair.pdec,
                               torch.from_numpy(sem_idx), torch.from_numpy(x_T),
                               noise=torch.from_numpy(noise), compute_dtype=BF16)
    assert (pf.fused_ddpm.launches, pf.fused_ddpm.bf16_launches) == before
    assert np.abs(want[jnp.float32]).max() > 10.0  # the recurrence has grown
    witness("DDPM", got.numpy(), want[jnp.bfloat16], want[jnp.float32])


def test_ddpm_bf16_mods_table_is_jax_fold_then_round(pair):
    """n1s = bf16(te) . bf16(ker[:, :H] * wn) + wn * (1 + bias[:H]) and
    n1b = bf16(te) . bf16(ker[:, H:]) + bias[H:] (norm3 likewise), float32
    sums: what ``_ddpm_kernel`` computes per step on ``fused_ddpm_sample``'s
    fold; 1e-6 (two float32 summation orders of 32 terms)."""
    H, L = pair.jcfg.hidden, pair.jcfg.layers
    t_seq = np.arange(DDPM_STEPS - 1, -1, -1)
    te = j_time_cond(pair.params, jnp.asarray(t_seq, jnp.float32),
                     jnp.zeros(DDPM_STEPS, jnp.int32)).astype(jnp.bfloat16)

    def mm(a, b):
        return jax.lax.dot_general(a, b.astype(jnp.bfloat16), (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.float32)

    want = []
    for l in range(L):
        per = []
        for which in ("norm1", "norm3"):
            q = pair.params[f"layers_{l}"][which]
            wn, ker, bias = q["norm"]["weight"], q["proj"]["kernel"], q["proj"]["bias"]
            per += [mm(te, ker[:, :H] * wn[None, :]) + wn * (1.0 + bias[:H]),
                    mm(te, ker[:, H:]) + bias[H:]]
        want.append(np.stack([np.asarray(p) for p in per], axis=1))
    want = np.stack(want, axis=1)  # [steps, L, 4, H]
    sem_idx, _ = _inputs()
    with torch.no_grad():
        loop = pf.prepare_loop_inputs(pair.pdec, torch.from_numpy(sem_idx), 2 * S, list(t_seq),
                                      step_idx=torch.zeros(DDPM_STEPS, dtype=torch.long),
                                      mods_dtype=BF16)
    assert loop["mods"].dtype == torch.float32
    np.testing.assert_allclose(loop["mods"].numpy(), want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("steps,prediction", [(4, "eps"), (2, "v")])
def test_fused_prenet_bf16_witness_vs_jax_xla(prenet_pair, steps, prediction):
    """The loop with the depthwise pre-net at an odd T (25 frames of 12
    tokens) against JAX's XLA ``ddim_sample`` over its bf16 decoder."""
    p = prenet_pair
    sem_idx, x_T = _inputs(T=25, seed=4)
    jsched = JSchedule.create(p.jcfg.diff_steps)

    def jax_loop(dt):
        dec = JDecoder(p.jcfg, dtype=dt)
        apply = jax.jit(lambda x, t, i: dec.apply({"params": p.params}, x, t,
                                                  sem_idx=jnp.asarray(sem_idx), step_idx=i))
        return j_ddim_sample(jsched, apply, jnp.asarray(x_T), steps, prediction)

    want = {dt: p.jax(("prenet", steps, prediction, dt), lambda dt=dt: jax_loop(dt))
            for dt in (jnp.float32, jnp.bfloat16)}
    got = pf.fused_generate_mel(p.pcfg, PSchedule.create(p.pcfg.diff_steps), p.pdec,
                                torch.from_numpy(sem_idx), torch.from_numpy(x_T), steps,
                                prediction, compute_dtype=BF16)
    assert got.shape == (B, 25, 80)
    witness(f"pre-net DDIM {steps} {prediction}", got.numpy(), want[jnp.bfloat16],
            want[jnp.float32])


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significand bits), 2^-133 at 0."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("T,d,window", [(200, 16, 5), (150, 40, 64), (96, 32, 0)])
def test_banded_attention_plain_bf16_matches_jax_kernel(T, d, window):
    """bf16 q, k, v: float32 inside, the output rounded to bf16 in both; the
    two differ by at most one bf16 ulp of the larger of the two outputs."""
    rng = np.random.RandomState(T + d)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, T, d).astype(np.float32)).to(BF16)
               for _ in range(3))
    want = np.asarray(j_band(*(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
                             window, interpret=True), np.float32)
    before = wa.banded_attention.bf16_launches
    got = wa.banded_attention(q, k, v, window)
    assert wa.banded_attention.bf16_launches == before and got.dtype == BF16
    got = got.float().numpy()
    ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= ulp), np.abs(got - want).max()


def test_packing_and_band_refuse_float16(pair):
    """Weight packing and the band route refuse float16, naming it (the two
    fused entry points' refusal is tests/test_torch_bf16.py's)."""
    half = torch.float16
    with pytest.raises(ValueError, match="float16"):
        pf.pack_decoder_weights(pair.pdec, half)
    q = torch.zeros(1, 2, 16, 8, dtype=half)
    with pytest.raises(ValueError, match="float16"):
        wa.banded_attention(q, q, q, 2)


def test_bf16_packing_and_loop_inputs(pair):
    """The products' weights are packed at bf16 (once), the rest float32;
    the loop inputs stay float32 for a decoder built at bf16 compute, equal
    to those of its float32 twin bit for bit (its modules run at float32)."""
    w = pf.pack_decoder_weights(pair.pdec, BF16)
    assert {n for n, t in w.items() if t.dtype == BF16} == set(pf.PRODUCT_NAMES) - {"pc_pw"}
    w32 = pf.pack_decoder_weights(pair.pdec)
    for n in pf.PRODUCT_NAMES[:-1]:
        assert torch.equal(w[n], w32[n].to(BF16))
    dec16 = PDecoder(pair.pcfg, dtype=BF16)
    dec16.load_state_dict(pair.pdec.state_dict())
    sem_idx, _ = _inputs()
    with torch.no_grad():
        a = pf.prepare_loop_inputs(dec16.eval(), torch.from_numpy(sem_idx), 24, [999, 499])
        b = pf.prepare_loop_inputs(pair.pdec, torch.from_numpy(sem_idx), 24, [999, 499])
    for k in a:
        assert a[k].dtype == torch.float32 and torch.equal(a[k], b[k]), k


# The float32 plain step as it stood before the bf16 variant (a frozen copy):
# the float32 path must not move by one bit.
def _gemm32(a, w, *, bias=None, pos=None, residual=None, norm=None, scale=None, shift=None,
            swiglu_=False):
    K = a.shape[-1]
    if norm == "rms":
        a = a * torch.rsqrt(a.square().mean(-1, keepdim=True) + 1e-6) * scale
        if shift is not None:
            a = a + shift
    elif norm == "ln":
        a = F.layer_norm(a, (K,), scale, shift, eps=1e-6)
    c = a @ w.T
    if bias is not None:
        c = c + bias
    if swiglu_:
        c = swiglu(c)
    if pos is not None:
        rows = torch.arange(c.numel() // c.shape[-1]) % pos.shape[0]
        c = c + pos[rows].reshape(c.shape)
    if residual is not None:
        c = residual + c
    return c


def _step32(x, pos, m_i, ckv, w, heads, window):
    Bx, T, _ = x.shape
    H, L, Sx = pos.shape[1], ckv.shape[0], ckv.shape[2]
    dh = H // heads

    def split(t, n):
        return t.reshape(Bx, n, heads, dh).transpose(1, 2)

    def merge(t):
        return t.transpose(1, 2).reshape(Bx, T, H)

    h = _gemm32(x, w["in_w"], bias=w["in_b"], pos=pos)
    for l in range(L):
        m = m_i[l]
        qkv = _gemm32(h, w["qkv_w"][l], norm="rms", scale=m[0], shift=m[1])
        q, k, v = (split(qkv[..., j * H:(j + 1) * H], T) for j in range(3))
        h = _gemm32(merge(wa.banded_attention_plain(q, k, v, window)), w["proj_w"][l],
                    bias=w["proj_b"][l], residual=h)
        q = split(_gemm32(h, w["cq_w"][l], norm="rms", scale=w["n2w"][l]), T)
        a = merge(sdpa(q, split(ckv[l, ..., :H], Sx), split(ckv[l, ..., H:], Sx)))
        h = _gemm32(a, w["co_w"][l], residual=h)
        f = _gemm32(h, w["fc1_w"][l], bias=w["fc1_b"][l], norm="rms", scale=m[2], shift=m[3],
                    swiglu_=True)
        h = _gemm32(f, w["fc2_w"][l], bias=w["fc2_b"][l], residual=h)
    return _gemm32(h, w["out_w"], bias=w["out_b"], norm="ln", scale=w["fn_s"], shift=w["fn_b"])


def _loop32(dec, sem_idx, T, ts, step_idx):
    ctx = dec.context(sem_idx=sem_idx)
    ckv = torch.stack([b.cross_attn.kv_up_proj(b.cross_attn.kv_norm(
        b.cross_attn.kv_down_proj(ctx))) for b in dec.layers])
    te = dec.time_cond(torch.tensor(ts, dtype=torch.float32), step_idx)
    mods = []
    for b in dec.layers:
        per = []
        for norm in (b.norm1, b.norm3):
            scale, shift = norm.proj(te).chunk(2, dim=-1)
            per += [norm.norm.weight * (1.0 + scale), shift]
        mods.append(torch.stack(per, dim=1))
    return dec.pos_emb.table[:T], torch.stack(mods, dim=1), ckv


@pytest.mark.parametrize("prediction", ["eps", "v"])
def test_float32_plain_is_the_float32_path_before_bit_for_bit(pair, prediction):
    sem_idx, x_T = (torch.from_numpy(a) for a in _inputs(seed=7))
    sched = PSchedule.create(pair.pcfg.diff_steps)
    heads, window = pair.pcfg.heads, pair.pcfg.attn_window_size
    ts, coef = pf.ddim_coefficients(sched, 4)
    with torch.no_grad():
        pos, mods, ckv = _loop32(pair.pdec, sem_idx, 2 * S, ts, torch.arange(4))
        w = pf.pack_decoder_weights(pair.pdec)
        x, x0 = x_T, None
        for i in range(len(ts)):
            pred = _step32(x, pos, mods[i], ckv, w, heads, window)
            sab, s1m, sabp, s1mp = coef[i]
            eps = s1m * x + sab * pred if prediction == "v" else pred
            x0 = ((x - s1m * eps) / sab).clamp(-pf.X0_CLIP, pf.X0_CLIP)
            x = sabp * x0 + s1mp * eps
        got = pf.fused_generate_mel(pair.pcfg, sched, pair.pdec, sem_idx, x_T, 4, prediction)
        loop = pf.prepare_loop_inputs(pair.pdec, sem_idx, 2 * S, ts)
    assert torch.equal(got, x0)
    assert all(torch.equal(loop[k], v) for k, v in (("pos", pos), ("mods", mods), ("ckv", ckv)))
