"""The port's bfloat16 compute against the JAX package in bfloat16, on the CPU.

Inputs are made with numpy from seeds, rounded to bfloat16 where a kernel
takes them, and go through the JAX function and the port's counterpart (on
the CPU, its plain versions). The JAX models run with the Pallas switch on,
as they are served (on the CPU their fused kernels fall through to their
references), and the kernels themselves in interpret mode.

Tolerances, with their reasons:

- the kernels #1, #5 and #6 and their input gradients, bfloat16 in and out:
  ``fused_conv.compare_bf16``, one bfloat16 ulp at the element plus 1e-4 of
  max|JAX|: each side rounds one float32 sum once, the sums in another
  order (the float32 kernels' 1e-4 covers that order where an element is
  small against the tensor's largest);
- the models, their serving pieces and a training step, the noise rule: the
  two frameworks round bfloat16 at different places (XLA's training-mode
  conv rounds its sum to bfloat16 before the bias add, the port's kernel
  once after it; XLA may keep an elementwise chain in float32 that the port
  rounds, or the reverse), so no bound tighter than the JAX package's own
  bfloat16 error is honest: for each output, max|port - JAX bf16| <=
  2 * max|JAX bf16 - JAX f32| + an absolute floor of 1e-3 (outputs and
  statistics of order 1; the loss terms' own bfloat16 error is far larger).
  Output dtypes equal JAX's exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simple_vae_rs_tpu.config import CondSRVAEConfig as JCondConfig
from simple_vae_rs_tpu.config import TrainConfig as JTrainConfig
from simple_vae_rs_tpu.config import VAEConfig as JVAEConfig
from simple_vae_rs_tpu.models import CondSRVAE as JCondSRVAE
from simple_vae_rs_tpu.models.srvae import SRVAE as JSRVAE
from simple_vae_rs_tpu.models.vae import VAE as JVAE
from simple_vae_rs_tpu.ops import pallas_conv as pc
from simple_vae_rs_tpu.ops import quantize as jq
from simple_vae_rs_tpu.serve import SuperResolver as JSuperResolver
from simple_vae_rs_tpu.train.engine import Trainer as JTrainer

from simple_vae_rs_tpu_torch import tasks as ttasks
from simple_vae_rs_tpu_torch.config import CondSRVAEConfig, TrainConfig, VAEConfig
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.models.srvae import SRVAE
from simple_vae_rs_tpu_torch.models.vae import VAE
from simple_vae_rs_tpu_torch.ops import conv_blocks as tblocks
from simple_vae_rs_tpu_torch.ops import fused_conv as fc
from simple_vae_rs_tpu_torch.ops import fused_int8 as f8
from simple_vae_rs_tpu_torch.ops import quantize as tq
from simple_vae_rs_tpu_torch.serve import SuperResolver
from simple_vae_rs_tpu_torch.train.engine import Trainer
from simple_vae_rs_tpu_torch.utils.jax_weights import _flatten, load_jax_variables
from tests.test_torch_port_conv import _random_bn

PS = 16
LR = 1e-4
FLOOR = 1e-3
BF16 = torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def pallas_on():
    prev = pc.is_enabled()
    pc.enable(True)
    yield
    pc.enable(prev)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _noise_rule(got, want_bf16, want_f32, what=""):
    """max|port - JAX bf16| <= 2 * max|JAX bf16 - JAX f32| + FLOOR."""
    g, wb, wf = _np(got), _np(want_bf16), _np(want_f32)
    assert g.shape == wb.shape == wf.shape, what
    assert np.isfinite(g).all(), what
    err = float(np.abs(g - wb).max())
    noise = float(np.abs(wb - wf).max())
    assert err <= 2 * noise + FLOOR, (what, err, noise)


def _dtype_of(t):
    return str(t.dtype).split(".")[-1]


# ------------------------------------------------------------------ kernels
def _bf16_data(shape, o, k, seed):
    """x and the HWIO kernel rounded to bfloat16 (held as float32, exact on
    both sides), scale and shift float32."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
    kern = torch.from_numpy((rng.standard_normal((k, k, shape[-1], o))
                             / np.sqrt(k * k * shape[-1])).astype(np.float32)).bfloat16()
    scale = rng.uniform(0.5, 1.5, o).astype(np.float32)
    shift = rng.standard_normal(o).astype(np.float32)
    return x, kern, scale, shift


def _jbf16(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


_PALLAS = {"fused_conv3x3_bn_relu": pc.fused_conv3x3_bn_relu,
           "fused_conv4x4s2_bn_relu": pc.fused_conv4x4s2_bn_relu,
           "fused_convT4x4s2_bn_relu": pc.fused_convT4x4s2_bn_relu}

# C % 8 == 0 beside C % 8 != 0, odd O, and for each conv its own shape; the
# last one's input gradient is a #5 launch that conv_wg_bf16 takes on the card
# (C = 16, O = 24, even H and W)
_WG_DX_CASE = ("fused_convT4x4s2_bn_relu", (2, 4, 4, 24), 16, False)
KERNEL_CASES = [
    ("fused_conv3x3_bn_relu", (2, 8, 8, 16), 8, True),
    ("fused_conv3x3_bn_relu", (2, 7, 9, 5), 13, False),
    ("fused_conv3x3_bn_relu", (1, 4, 4, 53), 24, True),
    ("fused_conv4x4s2_bn_relu", (2, 8, 8, 16), 24, True),
    ("fused_conv4x4s2_bn_relu", (2, 8, 6, 5), 9, False),
    ("fused_convT4x4s2_bn_relu", (2, 4, 4, 16), 8, True),
    ("fused_convT4x4s2_bn_relu", (2, 3, 5, 7), 13, False),
    _WG_DX_CASE,
]


@pytest.mark.parametrize("case", KERNEL_CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[3]}")
def test_bf16_plain_kernels_match_the_pallas_kernels(case):
    name, shape, o, relu = case
    x, kern, s, t = _bf16_data(shape, o, 4 if "4x4" in name else 3, seed=sum(shape) + o)
    want = _PALLAS[name](_jbf16(x), _jbf16(kern), s, t, relu=relu, interpret=True)
    got = fc.PLAIN[name](x, kern, torch.from_numpy(s), torch.from_numpy(t), relu)
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(getattr(fc, name)(x, kern, torch.from_numpy(s), torch.from_numpy(t),
                                         relu=relu), got)
    wb = torch.from_numpy(np.array(want.astype(jnp.float32))).bfloat16()
    assert fc.compare_bf16(got, wb)["of_bound"] <= 1.0


@pytest.mark.parametrize("case", KERNEL_CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_bf16_input_gradients_match_the_pallas_kernels(case):
    """``input_grad`` in bfloat16 (the adjoint's kernel on the flip-swapped
    weight, scale 1, shift 0) against the JAX Pallas kernel that computes it
    (#1 for the 3x3 conv, ``conv4x4s2_dx`` = #6 for the strided conv, #5 for
    the transposed conv), in interpret mode."""
    name, shape, o, _ = case
    x, kern, _, _ = _bf16_data(shape, o, 4 if "4x4" in name else 3, seed=2 * sum(shape) + o)
    out_shape = fc.output_shape(name, shape, o)
    g = torch.from_numpy(np.random.default_rng(o).standard_normal(out_shape)
                         .astype(np.float32)).bfloat16()
    c = shape[-1]
    ones, zeros = jnp.ones((c,), jnp.float32), jnp.zeros((c,), jnp.float32)
    if name == "fused_conv4x4s2_bn_relu":
        want = pc.conv4x4s2_dx(_jbf16(g), _jbf16(kern), in_hw=shape[1:3], interpret=True)
    else:
        want = _PALLAS[fc.DX_KERNEL[name]](_jbf16(g), pc._flip_swap(_jbf16(kern)), ones, zeros,
                                           relu=False, interpret=True)
    got = fc.input_grad(name, g, kern, shape, plain=True)
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16 and got.shape == shape
    if case == _WG_DX_CASE:  # a shape conv_wg_bf16 takes on the card
        assert fc._wg_takes(fc.DX_KERNEL[name], tuple(g.shape), c)
    assert torch.equal(fc.input_grad(name, g, kern, shape), got)  # CPU: the plain route
    wb = torch.from_numpy(np.array(want.astype(jnp.float32))).bfloat16()
    assert fc.compare_bf16(got, wb)["of_bound"] <= 1.0


def test_bf16_fused_conv_backward_follows_the_jax_vjp():
    """The Function's bfloat16 backward against the JAX custom VJP: dx and
    dk in bfloat16 (the rounding of g * scale once, as ``_make_grad``),
    dscale and dshift in float32."""
    name = "fused_conv3x3_bn_relu"
    x, kern, s, t = _bf16_data((2, 6, 6, 8), 8, 3, seed=3)
    g = np.random.default_rng(4).standard_normal((2, 6, 6, 8)).astype(np.float32)
    jfn = pc.fused_conv3x3_bn_relu_grad
    _, pull = jax.vjp(lambda a, b, c, d: jfn(a, b, c, d, True), _jbf16(x), _jbf16(kern),
                      jnp.asarray(s), jnp.asarray(t))
    want = pull(jnp.asarray(g).astype(jnp.bfloat16))
    tin = [x.clone().requires_grad_(), kern.clone().requires_grad_(),
           torch.from_numpy(s).requires_grad_(), torch.from_numpy(t).requires_grad_()]
    out = fc.fused_conv(name, *tin, True)
    got = torch.autograd.grad(out, tin, torch.from_numpy(g).bfloat16())
    for gt, w, dt in zip(got, want, (BF16, BF16, torch.float32, torch.float32)):
        assert gt.dtype == dt and _dtype_of(w) == _dtype_of(gt)
        wf = _np(w)
        err = float(np.abs(_np(gt) - wf).max())
        # dx, dk: rounded once each side; dscale, dshift: float32 sums of the
        # same bfloat16 products
        assert err <= 2.0**-7 * float(np.abs(wf).max()) + 1e-5, (dt, err)


# ------------------------------------------------------------------- models
def _families():
    """(kind, JAX f32 model, JAX bf16 model, variables, port bf16 model)."""
    out = []
    key = jax.random.PRNGKey(0)
    jc = JCondConfig(cr=2.0, patch_size=PS)
    jm = JCondSRVAE(jc)
    v = jm.init({"params": key}, jnp.zeros((1, PS, PS, 4)), jnp.zeros((1, PS // 2, PS // 2, 4)),
                jax.random.PRNGKey(1), train=False)
    out.append(("cond", jm, JCondSRVAE(jc, dtype=jnp.bfloat16), _random_bn(v, 21),
                CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS), dtype=BF16)))
    jm = JSRVAE(jc)
    v = jm.init({"params": key}, jnp.zeros((1, PS, PS, 4)), jax.random.PRNGKey(1), train=False)
    out.append(("srvae", jm, JSRVAE(jc, dtype=jnp.bfloat16), _random_bn(v, 22),
                SRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS), dtype=BF16)))
    jv = JVAEConfig(cr=2.0, patch_size=PS)
    jm = JVAE(jv)
    v = jm.init({"params": key}, jnp.zeros((1, PS, PS, 4)), jax.random.PRNGKey(1), train=False)
    out.append(("vae", jm, JVAE(jv, dtype=jnp.bfloat16), _random_bn(v, 23),
                VAE(VAEConfig(cr=2.0, patch_size=PS), dtype=BF16)))
    for _, _, _, variables, tmodel in out:
        load_jax_variables(tmodel, variables)
    return out


@pytest.fixture(scope="module")
def families():
    return {f[0]: f[1:] for f in _families()}


def _cond_eps(key, cfg, batch):
    rng_u, rng_z = jax.random.split(key)
    g = cfg.patch_size // 8
    return (np.asarray(jax.random.normal(rng_u, (batch, g, g, cfg.u_channels))),
            np.asarray(jax.random.normal(rng_z, (batch, g, g, cfg.z_channels))))


def _forward_args(kind, jmodel, batch, seed):
    """(JAX args after the variables, port args) of one forward pass, with
    the noise the JAX model draws handed to the port."""
    rng = np.random.default_rng(seed)
    x = rng.random((batch, PS, PS, 4)).astype(np.float32)
    y = rng.random((batch, PS // 2, PS // 2, 4)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    if kind == "vae":
        eps = np.asarray(jax.random.normal(key, (batch, jmodel.config.latent_dim)))
        return (x, key), [torch.from_numpy(np.array(a)) for a in (x, eps)]
    eps = _cond_eps(key, jmodel.config, batch)
    if kind == "srvae":
        return (x, key), [torch.from_numpy(np.array(a)) for a in (x, *eps)]
    return (x, y, key), [torch.from_numpy(np.array(a)) for a in (x, y, *eps)]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", ["cond", "srvae", "vae"])
def test_bf16_model_forward_matches_jax_bf16(families, kind, train):
    jf, jb, variables, tmodel = families[kind]
    jargs, targs = _forward_args(kind, jf, 3, seed=31)
    if train:
        want_f, new_f = jf.apply(variables, *jargs, train=True, mutable=["batch_stats"])
        want_b, new_b = jb.apply(variables, *jargs, train=True, mutable=["batch_stats"])
        fresh = type(tmodel)(tmodel.config, dtype=BF16)
        load_jax_variables(fresh, variables)
        got = fresh.train()(*targs)
        stats = dict(fresh.named_buffers())
        for name, wb in _flatten(new_b["batch_stats"]).items():
            assert stats[name].dtype == torch.float32
            _noise_rule(stats[name], wb, _flatten(new_f["batch_stats"])[name], name)
    else:
        want_f = jf.apply(variables, *jargs, train=False)
        want_b = jb.apply(variables, *jargs, train=False)
        with torch.no_grad():
            got = tmodel.eval()(*targs)
    assert len(got) == len(want_b)
    for i, (g, wb, wf) in enumerate(zip(got, want_b, want_f)):
        assert _dtype_of(g) == _dtype_of(wb), (i, g.dtype, wb.dtype)
        _noise_rule(g, wb, wf, f"{kind} output {i}")


def test_bf16_cond_serving_pieces_match_jax_bf16(families):
    """``conditional_generation_eps`` and the N-draw decode of
    ``sample_chunked`` on injected noise; the resolver's outputs float32."""
    jf, jb, variables, tmodel = families["cond"]
    cfg = tmodel.config
    rng = np.random.default_rng(32)
    g = PS // 8
    y = rng.random((2, PS // 2, PS // 2, 4)).astype(np.float32)
    eps_u = rng.standard_normal((2, g, g, cfg.u_channels)).astype(np.float32)
    eps_z = rng.standard_normal((2, g, g, cfg.z_channels)).astype(np.float32)
    draws_z = rng.standard_normal((5, g, g, cfg.z_channels)).astype(np.float32)

    def draws(m, y, eps_u, eps_z):
        mu_u, lv_u = m.encode_y(y, train=False)
        y_feat = m.y_embedding(y, train=False)
        mu_p, lv_p = m.z_cond(y_feat, mu_u + eps_u * jnp.exp(0.5 * lv_u), train=False)
        z = mu_p + eps_z * jnp.exp(0.5 * lv_p)
        yf = jnp.broadcast_to(y_feat, (z.shape[0],) + y_feat.shape[1:])
        return m.decode_x_from_features(z, yf, train=False)

    tmodel.eval()
    for fn, jargs, targs in (
            (JCondSRVAE.conditional_generation_eps, (y, eps_u, eps_z), (y, eps_u, eps_z)),
            (draws, (y[:1], eps_u[:1], draws_z), None)):
        want_f = jf.apply(variables, *jargs, method=fn)
        want_b = jb.apply(variables, *jargs, method=fn)
        with torch.no_grad():
            if targs is None:
                got = ttasks.sample_chunked(tmodel, torch.from_numpy(y[:1]), samples=5, chunk=2,
                                            eps_u=torch.from_numpy(eps_u[:1]),
                                            eps_z=torch.from_numpy(draws_z))
            else:
                got = tmodel.conditional_generation_eps(*map(torch.from_numpy, targs))
        assert got.dtype == torch.float32 and want_b.dtype == jnp.float32
        _noise_rule(got, want_b, want_f, fn.__name__ if hasattr(fn, "__name__") else "draws")
    sr = SuperResolver(tmodel, device="cpu", chain=True)
    out = sr.super_resolve(y * 900, seed=1)
    maps = sr.uncertainty(y[0] * 900, samples=4, chunk=2, seed=2)
    assert out.dtype == torch.float32 and all(v.dtype == torch.float32 for v in maps.values())
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0


def test_bf16_int8_modes_raise_and_name_the_roadmap_item(families):
    """A bfloat16 model takes both int8 modes, as the JAX resolver does.
    ``int8``: the quant tree is the float32 model's, byte for byte
    (quantized from the float32 parameters), and the decoder's int8 convs
    take bfloat16 input and give bfloat16 output. ``int8_weights``: the packed leaves are the float32
    model's and unpack to float32 parameters, which the convs cast to
    bfloat16. Every served output is float32."""
    _, _, variables, tmodel = families["cond"]
    y = np.random.default_rng(36).random((2, PS // 2, PS // 2, 4)).astype(np.float32)
    m32 = CondSRVAE(tmodel.config)
    load_jax_variables(m32, variables)
    sr, sr32 = (SuperResolver(m, device="cpu", seed=5, int8=True) for m in (tmodel, m32))
    assert sr.model.dtype == BF16 and tq.has_quant(sr.model) and not tq.has_quant(tmodel)
    for a, b in zip(tq._conv_modules(sr.model), tq._conv_modules(sr32.model)):
        assert (a[1].kernel_q is None) == (b[1].kernel_q is None)
        if a[1].kernel_q is not None:
            assert torch.equal(a[1].kernel_q, b[1].kernel_q)
            assert torch.equal(a[1].kernel_s, b[1].kernel_s)
    seen = []
    hooks = [mod.register_forward_hook(lambda m, a, out: seen.append((a[0].dtype, out.dtype)))
             for mod in sr.model.modules()
             if isinstance(mod, tblocks.Conv3x3) and mod.kernel_q is not None]
    out = sr.super_resolve(y, seed=1)
    for h in hooks:
        h.remove()
    assert len(seen) == 7 and all(o == BF16 for _, o in seen)
    assert out.dtype == torch.float32 and float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    srw, srw32 = (SuperResolver(m, device="cpu", int8_weights=True) for m in (tmodel, m32))
    assert srw._packed.keys() == srw32._packed.keys() and len(srw._packed) > 20
    for name, (q, sc) in srw._packed.items():
        assert torch.equal(q, srw32._packed[name][0]) and torch.equal(sc, srw32._packed[name][1])
    with tq.unpack_weights(srw.model, srw._packed):
        params = dict(srw.model.named_parameters())
        assert all(params[n].dtype == torch.float32 and params[n].numel() > 0
                   for n in srw._packed)
    maps = srw.uncertainty(y[0], samples=4, chunk=2, seed=2)
    assert all(v.dtype == torch.float32 for v in maps.values())


def _cond_requests(cfg, samples, seed):
    """Numpy LR windows and noise: (y, eps_u, eps_z, the draws' eps_z)."""
    rng = np.random.default_rng(seed)
    g = PS // 8
    return (rng.random((2, PS // 2, PS // 2, 4)).astype(np.float32),
            rng.standard_normal((2, g, g, cfg.u_channels)).astype(np.float32),
            rng.standard_normal((2, g, g, cfg.z_channels)).astype(np.float32),
            rng.standard_normal((samples, g, g, cfg.z_channels)).astype(np.float32))


def _draws(m, y, eps_u, eps_z):
    """The N-draw decode of one window (``tasks.sample_chunked``) in JAX."""
    mu_u, lv_u = m.encode_y(y, train=False)
    y_feat = m.y_embedding(y, train=False)
    mu_p, lv_p = m.z_cond(y_feat, mu_u + eps_u * jnp.exp(0.5 * lv_u), train=False)
    z = mu_p + eps_z * jnp.exp(0.5 * lv_p)
    yf = jnp.broadcast_to(y_feat, (z.shape[0],) + y_feat.shape[1:])
    return m.decode_x_from_features(z, yf, train=False)


def _int8_requests(jf, jb, jvars, tmodel, reqs, packed=None):
    """The two requests (``conditional_generation_eps`` on two windows and
    the one-chunk N-draw decode of the first) through the JAX model in
    float32 and in bfloat16 on ``jvars`` and through the port's bfloat16
    model: [(port, JAX bf16, JAX f32)] each."""
    y, eps_u, eps_z, draws_z = reqs
    t = torch.from_numpy
    out = []
    for fn, jargs in ((JCondSRVAE.conditional_generation_eps, (y, eps_u, eps_z)),
                      (_draws, (y[:1], eps_u[:1], draws_z))):
        with torch.no_grad(), tq.unpack_weights(tmodel, packed):
            if fn is _draws:  # one chunk: a decode chunk's activation scale is its own
                got = ttasks.sample_chunked(tmodel, t(y[:1]), samples=len(draws_z),
                                            chunk=len(draws_z), eps_u=t(eps_u[:1]),
                                            eps_z=t(draws_z))
            else:
                got = tmodel.conditional_generation_eps(t(y), t(eps_u), t(eps_z))
        out.append((got, jb.apply(jvars, *jargs, method=fn), jf.apply(jvars, *jargs, method=fn)))
    return out


def test_bf16_w8a8_resolver_matches_jax_bf16(families):
    """``SuperResolver(int8=True)`` on the bfloat16 model: the JAX
    resolver of its bfloat16 model quantizes, the port loads that ``quant``
    collection (served as it is), and both run the same requests on
    injected noise; the port's bfloat16 W8A8 against JAX's by the noise
    rule, JAX float32 being the same W8A8 weights on the float32 model. The
    int8 kernels' plain versions run, in bfloat16, and the decoder's int8
    convs really route (the float32 parameters' output differs)."""
    jf, jb, variables, tmodel = families["cond"]
    jsr = JSuperResolver(jb, variables, seed=7, int8=True)
    qvars = jax.device_get(jsr.variables)
    m = CondSRVAE(tmodel.config, dtype=BF16)
    load_jax_variables(m, qvars)
    sr = SuperResolver(m, device="cpu", seed=7, int8=True)
    assert sr.model is m and tq.has_quant(m)
    calls = []
    orig = f8.int8_conv

    def spy(name, x, *args, **kw):
        calls.append(x.dtype)
        return orig(name, x, *args, **kw)

    f8.int8_conv = spy
    try:
        results = _int8_requests(jf, jb, qvars, sr.model.eval(),
                                 _cond_requests(m.config, 5, seed=37))
    finally:
        f8.int8_conv = orig
    assert calls and all(dt == BF16 for dt in calls)
    for i, (got, wb, wf) in enumerate(results):
        assert got.dtype == torch.float32 and wb.dtype == jnp.float32
        _noise_rule(got, wb, wf, f"W8A8 request {i}")
    with torch.no_grad():
        off = tmodel.eval().conditional_generation_eps(
            *map(torch.from_numpy, _cond_requests(m.config, 5, seed=37)[:3]))
    assert float((off - results[0][0]).abs().max()) > 1e-4


def test_bf16_int8_weights_resolver_matches_jax_bf16(families):
    """``SuperResolver(int8_weights=True)`` on the bfloat16 model: both
    packages dequantize the same bytes to float32 parameters and run the
    bfloat16 graph; against JAX's bfloat16 model on its unpacked weights by
    the noise rule, JAX float32 being the float32 model on the same
    unpacked weights."""
    jf, jb, variables, tmodel = families["cond"]
    jsr = JSuperResolver(jb, variables, seed=7, int8_weights=True)
    jvars = jq.unpack_weights(jsr._payload, jsr._pack_spec)
    sr = SuperResolver(tmodel, device="cpu", seed=7, int8_weights=True)
    assert sr.model is not tmodel and sr.model.dtype == BF16
    results = _int8_requests(jf, jb, jvars, sr.model, _cond_requests(tmodel.config, 4, seed=38),
                             packed=sr._packed)
    for i, (got, wb, wf) in enumerate(results):
        assert got.dtype == torch.float32
        _noise_rule(got, wb, wf, f"weights-only request {i}")
    params = dict(sr.model.named_parameters())
    assert all(params[n].numel() == 0 for n in sr._packed)  # released between requests


def test_bf16_vae_sample_chunked_matches_jax_bf16(families):
    jf, jb, variables, tmodel = families["vae"]
    rng = np.random.default_rng(33)
    y = rng.random((1, PS, PS, 4)).astype(np.float32)
    eps = rng.standard_normal((5, tmodel.config.latent_dim)).astype(np.float32)

    def draws(m, y, eps):
        mu, logvar = m.encode(y, train=False)
        return m.decode(mu + eps * jnp.exp(0.5 * logvar), train=False)

    want_f = jf.apply(variables, y, eps, method=draws)
    want_b = jb.apply(variables, y, eps, method=draws)
    tmodel.eval()
    got = ttasks.sample_chunked(tmodel, torch.from_numpy(y), samples=5, chunk=2,
                                eps_z=torch.from_numpy(eps))
    assert got.dtype == torch.float32
    _noise_rule(got, want_b, want_f, "vae draws")
    maps = ttasks.uncertainty_maps(tmodel, torch.from_numpy(y), torch.Generator().manual_seed(1),
                                   samples=4, chunk=2)
    assert all(v.dtype == torch.float32 for v in maps.values())


# -------------------------------------------------------------- cast points
def _port_dtypes(model, args):
    """Module name -> (input dtype, output dtype) of every call of a port
    module in one forward pass (the last call of a module wins)."""
    seen = {}
    hooks = []
    for name, mod in model.named_modules():
        if name:
            hooks.append(mod.register_forward_hook(
                lambda m, a, out, name=name: seen.__setitem__(
                    name, (_dtype_of(a[0]), _dtype_of(out if torch.is_tensor(out) else out[0])))))
    try:
        model(*args)
    finally:
        for h in hooks:
            h.remove()
    return seen


@pytest.mark.parametrize("kind", ["cond", "vae"])
def test_bf16_cast_points_are_the_jax_models(families, kind):
    """The dtype at every cast point of the Cond_SRVAE and the VAE in
    training mode: each module's output dtype equals the JAX module's of
    the same name (flax ``capture_intermediates``), and the inputs of the
    decoders and of the prior's u branch are bfloat16 while the noise, the
    heads and the outputs are float32."""
    jf, jb, variables, tmodel = families[kind]
    jargs, targs = _forward_args(kind, jf, 2, seed=34)
    outs, mutated = jb.apply(variables, *jargs, train=True, mutable=["batch_stats"],
                             capture_intermediates=True)
    jdt = {}

    def walk(tree, path):
        for key, val in tree.items():
            if key == "__call__":  # the outputs of each call: the last one's (first) array
                last = val[-1]
                jdt[".".join(path)] = _dtype_of(last[0] if isinstance(last, tuple) else last)
            else:
                walk(val, path + (key,))

    walk(mutated["intermediates"], ())
    fresh = type(tmodel)(tmodel.config, dtype=BF16)
    load_jax_variables(fresh, variables)
    got = _port_dtypes(fresh.train(), targs)
    shared = sorted(set(got) & set(jdt))
    assert len(shared) >= (20 if kind == "cond" else 10)
    for name in shared:
        assert got[name][1] == jdt[name], (name, got[name], jdt[name])
    fresh_outs = fresh(*targs)
    assert [_dtype_of(o) for o in fresh_outs] == [_dtype_of(o) for o in outs]
    assert all(_dtype_of(o) == "float32" for o in fresh_outs)  # heads, outputs: float32
    if kind == "cond":
        # u cast to the y features' dtype; the decoders' inputs to bfloat16
        for name in ("uz_conv1", "dx_up1", "dy_up1", "yz_down1", "ex_down1"):
            want_in = "float32" if name in ("yz_down1", "ex_down1") else "bfloat16"
            assert got[name][0] == want_in, name
        assert got["ey_head"][1] == got["pz_lv_conv2"][1] == "bfloat16"
    else:
        assert got["dec_up1"][0] == "bfloat16" and got["enc_head"][1] == "bfloat16"


# ----------------------------------------------------------- a train step
@pytest.fixture(scope="module")
def jax_train_setup():
    """The JAX Trainer in ``bench.py``'s configuration (bf16 model,
    ``use_bfloat16``) and in float32, from one initial state."""
    jc = JCondConfig(cr=2.0, patch_size=PS)
    rng = np.random.default_rng(35)
    y = rng.random((8, PS // 2, PS // 2, 4)).astype(np.float32)
    x = rng.random((8, PS, PS, 4)).astype(np.float32)
    jt = JTrainer(JCondSRVAE(jc), JTrainConfig(learning_rate=LR))
    state0 = jax.tree_util.tree_map(np.array, jax.device_get(jt.init_state((y[:4], x[:4]))))
    return jc, state0, (y, x)


@pytest.mark.parametrize("accum", [1, 2])
def test_bf16_train_step_matches_jax_bench_configuration(jax_train_setup, accum):
    jc, state0, (y, x) = jax_train_setup
    b = 4 * accum
    batch = (y[:b], x[:b])
    step_rng = jax.random.fold_in(state0.rng, 0)
    rngs = [step_rng] if accum == 1 else [jax.random.fold_in(step_rng, i) for i in range(accum)]
    eps = [tuple(torch.from_numpy(np.array(a)) for a in _cond_eps(r, jc, 4)) for r in rngs]
    want = {}
    for dt in (None, jnp.bfloat16):
        jt = JTrainer(JCondSRVAE(jc, dtype=dt),
                      JTrainConfig(learning_rate=LR, accum_steps=accum,
                                   use_bfloat16=dt is not None))
        new_state, terms = jt._train_step(jax.tree_util.tree_map(jnp.asarray, state0),
                                          tuple(map(jnp.asarray, batch)), jnp.float32(LR))
        want[dt] = ({k: np.asarray(v) for k, v in terms.items()},
                    _flatten(jax.device_get(new_state.batch_stats)))
    tmodel = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS), dtype=BF16)
    load_jax_variables(tmodel, {"params": state0.params, "batch_stats": state0.batch_stats})
    trainer = Trainer(tmodel, TrainConfig(learning_rate=LR, accum_steps=accum,
                                          use_bfloat16=True), device="cpu")
    terms = trainer.train_step(batch, eps=eps)
    (terms_f, stats_f), (terms_b, stats_b) = want[None], want[jnp.bfloat16]
    for key in terms_b:
        assert terms[key].dtype == torch.float32
        _noise_rule(terms[key], terms_b[key], terms_f[key], key)
    buffers = dict(trainer.model.named_buffers())
    for name in stats_b:
        assert buffers[name].dtype == torch.float32
        _noise_rule(buffers[name], stats_b[name], stats_f[name], name)
    assert all(p.dtype == torch.float32 for p in trainer.params.values())
    assert trainer.step == 1
