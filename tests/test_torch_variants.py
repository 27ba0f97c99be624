"""The model variants of the PyTorch port against the JAX package's, on the
CPU: the s2d stem and d2s head, the ``group``, ``none`` and ``batch-subN``
norms, ``torch_compat``, ``remat`` and ``verbose``, on VanillaVAE, VQVAE,
FoldedVAE and FoldedVQVAE, with weights carried across by
``interop/from_jax.py`` and the same numpy inputs on both sides.

Widths: 32 px, hidden (8, 16) ((16, 64) for GroupNorm, so that groups hold
more than one channel), latent 4 (VQ: D = 4, K = 16), fold 2, batch 8.
The flax variables are the port's initial weights in flax's layout with
the biases, norm scales and running statistics perturbed; their tree must
equal the flax model's own (``jax.eval_shape`` of its init), so every leaf
is mapped once.

Tolerances: f32 within 1e-5 of the larger of 1 and the compared array's
largest magnitude (train-mode outputs, the running statistics and codebook
buffers after the update, eval-mode reconstructions; the convolutions sum
in another order on each side); bf16 within BF16_ULPS bf16 ulps of the
logits' largest magnitude (the two packages round their bf16
intermediates at different places), its f32 statistics within 2e-3.
Last, the train CLI with the variant flags, and evaluate, generate and the
server rebuilding the model from the checkpoint.

Remat: one train step with ``remat=True`` against ``remat=False`` in the
port is bitwise equal (loss, every gradient, every buffer), also under
``grad_accum=2``; against JAX with ``remat=True``, every gradient within
1e-5 of the larger of 1 and its largest magnitude.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midi_vae_tpu.models.registry import build_model as jax_build_model
from midi_vae_tpu_torch.interop.from_jax import flax_name_map, load_flax_variables, to_flax_layout
from midi_vae_tpu_torch.losses.schedules import kl_weight_schedule
from midi_vae_tpu_torch.models.registry import build_model
from midi_vae_tpu_torch.models.vae import GroupNorm, param_group_label
from midi_vae_tpu_torch.train.optim import build_optimizer
from midi_vae_tpu_torch.train.state import create_train_state, make_train_step
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5
BATCH = 8
GAUSS = dict(in_channels=1, latent_dim=4, input_dim=32, hidden_dims=(8, 16))
VQ = dict(GAUSS, codebook_size=16)
GN_DIMS = dict(hidden_dims=(16, 64))

CASES = {
    # id: (arch, variant kwargs)
    "vanilla_s2d": ("VanillaVAE", dict(stem="s2d")),
    "vanilla_d2s": ("VanillaVAE", dict(head="d2s")),
    "vanilla_s2d_d2s": ("VanillaVAE", dict(stem="s2d", head="d2s")),
    "vanilla_group": ("VanillaVAE", dict(norm="group", **GN_DIMS)),
    "vanilla_none": ("VanillaVAE", dict(norm="none")),
    "vanilla_sub2": ("VanillaVAE", dict(norm="batch-sub2")),
    "vanilla_sub4": ("VanillaVAE", dict(norm="batch-sub4")),
    "vanilla_torch_compat": ("VanillaVAE", dict(torch_compat=True)),
    "vq_s2d": ("VQVAE", dict(stem="s2d")),
    "vq_d2s": ("VQVAE", dict(head="d2s")),
    "vq_s2d_d2s": ("VQVAE", dict(stem="s2d", head="d2s")),
    "vq_group": ("VQVAE", dict(norm="group", **GN_DIMS)),
    "vq_none": ("VQVAE", dict(norm="none")),
    "vq_sub2": ("VQVAE", dict(norm="batch-sub2")),
    "vq_sub4": ("VQVAE", dict(norm="batch-sub4")),
    "folded_group": ("FoldedVAE", dict(fold=2, norm="group", **GN_DIMS)),
    "folded_none": ("FoldedVAE", dict(fold=2, norm="none")),
    "folded_sub2": ("FoldedVAE", dict(fold=2, norm="batch-sub2")),
    "folded_sub4": ("FoldedVAE", dict(fold=2, norm="batch-sub4")),
    "foldedvq_group": ("FoldedVQVAE", dict(fold=2, norm="group", **GN_DIMS)),
    "foldedvq_none": ("FoldedVQVAE", dict(fold=2, norm="none")),
    "foldedvq_sub2": ("FoldedVQVAE", dict(fold=2, norm="batch-sub2")),
    "foldedvq_sub4": ("FoldedVQVAE", dict(fold=2, norm="batch-sub4")),
}
BF16_CASES = ["vanilla_s2d_d2s", "vanilla_group", "folded_sub4", "vanilla_sub2"]
BF16_ULPS = 6  # measured here: 2.2–2.3 with a plain BatchNorm in the model, 3.2–4.2 with batch-subN


def _kw(case, **extra):
    arch, kw = CASES[case]
    base = VQ if "VQ" in arch else GAUSS
    return arch, {**base, **kw, **extra}


def _randomize(variables, rng):
    def leaf(path, v):
        name = path[-1].key
        v = np.asarray(v, np.float32)
        if name in ("kernel", "codebook", "embed_avg"):
            return v
        if name == "cluster_size":
            return rng.uniform(0.5, 3.0, v.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.2 * rng.normal(size=v.shape)).astype(np.float32)
        return (0.2 * rng.normal(size=v.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _to_flax(model) -> dict:
    variables = {"params": {}, "batch_stats": {}}
    for name, (collection, path) in flax_name_map(model).items():
        node = variables[collection]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = to_flax_layout(model, name, model.state_dict()[name])
    return variables


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


@functools.lru_cache(maxsize=None)
def _jax_side(case, dtype="float32"):
    """(flax model, perturbed variables, x, eps) for a case."""
    arch, kw = _kw(case)
    variables = _randomize(_to_flax(build_model(arch, device="cpu", **kw)), np.random.default_rng(0))
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (BATCH, 32, 32, 1)).astype(np.float32)
    eps = rng.normal(size=(BATCH, 4)).astype(np.float32)
    jkw = dict(kw, dtype=jnp.bfloat16) if dtype == "bfloat16" else kw
    return jax_build_model(arch, **jkw), variables, x, eps


def _pair(case, dtype="float32"):
    jmodel, variables, x, eps = _jax_side(case, dtype)
    arch, kw = _kw(case)
    tkw = dict(kw, dtype=torch.bfloat16) if dtype == "bfloat16" else kw
    model = build_model(arch, device="cpu", **tkw)
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    return jmodel, variables, model, x, eps


def _close(got, want, atol=None):
    """Within ``atol``; by default 1e-5 of the larger of 1 and the largest |want|."""
    want = np.asarray(want, np.float32)
    if atol is None:
        atol = ATOL * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got.detach().float() if torch.is_tensor(got) else got, np.float32),
                               want, rtol=0, atol=atol)


def _jax_train_forward(mdl, x, eps):
    if getattr(mdl, "latent_kind", "gaussian") == "vq":
        out = mdl(x, train=True)
        return out.encoded.mu, out.latents, out.logits
    enc = mdl.encode(x, train=True)
    z = enc.mu + eps * jnp.exp(0.5 * enc.log_var)
    return enc.mu, enc.log_var, mdl.decode_logits(z, train=True)


def _jax_eval_forward(mdl, x):
    return mdl.decode(mdl.encode(x, train=False).mu, train=False)


@pytest.mark.parametrize("case", list(CASES))
def test_train_forward_and_buffers_match_flax(case):
    """Train-mode outputs (eps injected) and every buffer after the update;
    the port's flax tree is the flax model's own."""
    jmodel, variables, model, x, eps = _pair(case)
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=True),
                            {"params": jax.random.PRNGKey(0), "reparam": jax.random.PRNGKey(1)}, jnp.asarray(x))
    ours = {k: v for k, v in variables.items() if v}  # "none" and GroupNorm keep no batch_stats
    assert jax.tree_util.tree_structure(dict(shapes)) == jax.tree_util.tree_structure(ours)
    assert jax.tree_util.tree_map(lambda s: s.shape, dict(shapes)) == jax.tree_util.tree_map(np.shape, ours)
    (a, b, logits), mutated = jax.jit(functools.partial(jmodel.apply, method=_jax_train_forward,
                                                        mutable=["batch_stats"]))(variables, x, eps)
    out = model(torch.from_numpy(x), train=True, eps=torch.from_numpy(eps))
    _close(out.logits, logits)
    _close(out.encoded.mu, a)
    _close(out.latents if getattr(model, "latent_kind", "") == "vq" else out.encoded.log_var, b)
    for name, (collection, path) in flax_name_map(model).items():
        if collection == "batch_stats":
            _close(to_flax_layout(model, name, model.state_dict()[name]), _leaf(mutated["batch_stats"], path))


@pytest.mark.parametrize("case", list(CASES))
def test_eval_reconstruction_matches_flax(case):
    """The posterior-mean reconstruction (what /reconstruct serves), running statistics."""
    jmodel, variables, model, x, _ = _pair(case)
    want = jax.jit(functools.partial(jmodel.apply, method=_jax_eval_forward))(variables, x)
    with torch.no_grad():
        got = model.decode(model.encode(torch.from_numpy(x), train=False).mu, train=False)
    _close(got, want)


@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_train_forward_matches_flax(case):
    jmodel, variables, model, x, eps = _pair(case, "bfloat16")
    (_, _, logits), mutated = jax.jit(functools.partial(jmodel.apply, method=_jax_train_forward,
                                                        mutable=["batch_stats"]))(variables, x, eps)
    out = model(torch.from_numpy(x), train=True, eps=torch.from_numpy(eps))
    assert out.logits.dtype == torch.bfloat16
    scale = float(np.abs(np.asarray(logits, np.float32)).max())
    err = float(np.abs(out.logits.float().detach().numpy() - np.asarray(logits, np.float32)).max())
    print(f"{case}: bf16 logits max |err| {err:.4g} at scale {scale:.4g} ({err / scale / 2.0 ** -8:.2f} ulps)")
    _close(out.logits, logits, atol=BF16_ULPS * 2.0 ** -8 * max(scale, 1.0))
    for name, (collection, path) in flax_name_map(model).items():
        if collection == "batch_stats":  # f32 statistics of bf16 activations
            _close(to_flax_layout(model, name, model.state_dict()[name]), _leaf(mutated["batch_stats"], path),
                   atol=2e-3)


# ------------------------------------------------------------ the pieces


@pytest.mark.parametrize("channels", [64, 96])
def test_group_norm_groups_contiguous_channels_as_flax(channels):
    """NCHW GroupNorm against flax ``nn.GroupNorm`` on NHWC: the same groups."""
    import flax.linen as fnn

    from midi_vae_tpu.models.vae import _gn_groups

    rng = np.random.default_rng(channels)
    # a per-channel offset makes a wrong grouping visible in the statistics
    x = (rng.normal(size=(3, 5, 6, channels)) + 0.05 * np.arange(channels)).astype(np.float32)
    jmod = fnn.GroupNorm(num_groups=_gn_groups(channels), epsilon=1e-5)
    variables = {"params": {"scale": rng.normal(size=channels).astype(np.float32),
                            "bias": rng.normal(size=channels).astype(np.float32)}}
    want = jmod.apply(variables, jnp.asarray(x))
    gn = GroupNorm(channels)
    assert gn.num_groups == _gn_groups(channels) and channels // gn.num_groups > 1
    load_flax_variables(gn, variables["params"], {})
    got = gn(torch.from_numpy(x).permute(0, 3, 1, 2), True).permute(0, 2, 3, 1)
    _close(got, want)


def test_s2d_stem_refuses_odd_sizes():
    model = build_model("VanillaVAE", device="cpu", **dict(GAUSS, input_dim=30, stem="s2d"))
    model(torch.zeros(2, 30, 30, 1), train=False, eps=torch.zeros(2, 4))  # 30 → 15 stays even at the stem
    with pytest.raises(ValueError, match="s2d stem needs even spatial dims, got 31x31"):
        build_model("VanillaVAE", device="cpu", **dict(GAUSS, input_dim=31, stem="s2d")).encode(torch.zeros(1, 31, 31, 1))


@pytest.mark.parametrize("arch,kwargs,match", [
    ("VanillaVAE", dict(torch_compat=True, stem="s2d"), "reference stem and head"),
    ("VanillaVAE", dict(torch_compat=True, head="d2s"), "reference stem and head"),
    ("VanillaVAE", dict(torch_compat=True, norm="batch-sub4"), "norm='batch'"),
    ("VanillaVAE", dict(torch_compat=True, num_classes=3), "no conditional"),
    ("VQVAE", dict(torch_compat=True), "no VQ-VAE"),
    ("FoldedVAE", dict(torch_compat=True), "has its own layout"),
    ("FoldedVAE", dict(stem="s2d"), "has its own layout"),
    ("FoldedVQVAE", dict(head="d2s"), "has its own layout"),
    ("MLPVAE", dict(norm="group"), "MLPVAE has no norm layers"),
    ("MLPVAE", dict(stem="s2d"), "MLPVAE has neither"),
    ("VanillaVAE", dict(norm="layer"), "unknown norm"),
])
def test_registry_refuses_what_jax_refuses(arch, kwargs, match):
    kw = dict(VQ if "VQ" in arch else GAUSS, **kwargs)
    with pytest.raises(ValueError, match=match):
        build_model(arch, device="cpu", **kw)
    if "num_classes" in kw:
        kw.pop("codebook_size", None)
    jkw = {k: v for k, v in kw.items()}
    with pytest.raises((ValueError, TypeError)):  # the JAX package refuses the same (at init for the modules)
        jm = jax_build_model(arch, **jkw)
        jm.init({"params": jax.random.PRNGKey(0), "reparam": jax.random.PRNGKey(1)}, jnp.zeros((2, 32, 32, 1)))


def test_verbose_prints_the_jax_stages_and_nothing_when_off(capsys):
    model = build_model("VanillaVAE", device="cpu", verbose=True, **GAUSS)
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (2, 32, 32, 1)).astype(np.float32))
    with torch.no_grad():
        out = model(x, train=False, eps=torch.zeros(2, 4))
    lines = capsys.readouterr().out.strip().splitlines()
    names = [ln.split(" ")[0] for ln in lines]
    assert names == ["encode/input", "encode/conv_out", "encode/mu", "encode/log_var", "decode/latents",
                     "decode/decoder_input", "decode/deconv_out", "decode/logits"]
    shapes = [ln.split("shape=")[1].split(" min")[0] for ln in lines]
    assert shapes == ["(2, 32, 32, 1)", "(2, 8, 8, 16)", "(2, 4)", "(2, 4)", "(2, 4)", "(2, 8, 8, 16)",
                      "(2, 16, 16, 8)", "(2, 32, 32, 1)"]  # NHWC, as JAX prints them
    assert lines[-1].endswith(f"min={float(out.logits.min()):.6g} max={float(out.logits.max()):.6g}")
    build_model("MLPVAE", device="cpu", verbose=True, **GAUSS)(x, train=False, eps=torch.zeros(2, 4))
    assert [ln.split(" ")[0] for ln in capsys.readouterr().out.splitlines()] == ["encode/input", "encode/hidden"]
    build_model("VanillaVAE", device="cpu", **GAUSS)(x, train=False, eps=torch.zeros(2, 4))
    assert capsys.readouterr().out == ""


# ------------------------------------------------------------------ remat


REMAT_CASES = {
    "vanilla_s2d_d2s_sub2": ("VanillaVAE", dict(GAUSS, stem="s2d", head="d2s", norm="batch-sub2")),
    "folded": ("FoldedVAE", dict(GAUSS, fold=2)),
    "vq": ("VQVAE", VQ),
    "foldedvq": ("FoldedVQVAE", dict(VQ, fold=2)),
}


def _step_state(arch, kw, remat):
    model = build_model(arch, device="cpu", remat=remat, seed=5, **kw)
    return create_train_state(model, build_optimizer(model, param_group_label, optimizer="AdamW", lr=1e-3,
                                                     scheduler="OneCycle", total_steps=100))


@pytest.mark.parametrize("grad_accum", [1, 2], ids=["one_pass", "grad_accum_2"])
@pytest.mark.parametrize("case", list(REMAT_CASES))
def test_remat_train_step_is_bitwise_the_plain_one(case, grad_accum):
    """One train step with remat on and off: loss, every gradient, every
    updated parameter and buffer bitwise equal (the recompute updates no
    running statistics and no codebook a second time)."""
    arch, kw = REMAT_CASES[case]
    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (BATCH, 32, 32, 1)).astype(np.float32))
    loss_type = "vq" if "VQ" in arch else "elbo"
    results = []
    for remat in (False, True):
        state = _step_state(arch, kw, remat)
        step = make_train_step(kl_weight_schedule("constant", 2.5e-4), grad_accum=grad_accum, loss_type=loss_type)
        grads = {}
        hooks = [p.register_post_accumulate_grad_hook(lambda p, n=n: grads.__setitem__(n, p.grad.clone()))
                 for n, p in state.model.named_parameters()]
        state, lo, grad_norm = step(state, x, 0)
        for h in hooks:
            h.remove()
        assert grads.keys() == {n for n, _ in state.model.named_parameters()}
        results.append((lo.loss, grad_norm, grads, state.model.state_dict()))
    (l0, g0, grads0, sd0), (l1, g1, grads1, sd1) = results
    assert torch.equal(l0, l1) and torch.equal(g0, g1)
    for name in grads0:
        assert torch.equal(grads0[name], grads1[name]), name
    for name in sd0:
        assert torch.equal(sd0[name], sd1[name]), name


@pytest.mark.parametrize("case", ["vanilla_s2d_d2s_sub2", "folded", "foldedvq"])
def test_remat_gradients_match_jax_remat(case):
    """The gradient of one train-mode forward's loss (mean logits², plus
    the latent's) under remat in both packages, and the buffers after."""
    arch, kw = REMAT_CASES[case]
    model = build_model(arch, device="cpu", remat=True, **kw)
    variables = _randomize(_to_flax(model), np.random.default_rng(3))
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    jmodel = jax_build_model(arch, remat=True, **kw)
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (BATCH, 32, 32, 1)).astype(np.float32)
    eps = rng.normal(size=(BATCH, 4)).astype(np.float32)

    def jax_loss(params):
        (a, b, logits), mutated = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]}, x, eps,
                                               method=_jax_train_forward, mutable=["batch_stats"])
        return jnp.mean(logits**2) + jnp.mean(a**2) + jnp.mean(b**2), mutated

    (_, mutated), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(variables["params"])
    out = model(torch.from_numpy(x), train=True, eps=torch.from_numpy(eps))
    second = out.latents if getattr(model, "latent_kind", "") == "vq" else out.encoded.log_var
    (out.logits.pow(2).mean() + out.encoded.mu.pow(2).mean() + second.pow(2).mean()).backward()
    for name, (collection, path) in flax_name_map(model).items():
        if collection == "params":
            _close(to_flax_layout(model, name, model.get_parameter(name).grad), _leaf(jgrads, path))
        else:
            _close(to_flax_layout(model, name, model.state_dict()[name]), _leaf(mutated["batch_stats"], path))


# ----------------------------------------------------------- through the CLIs


@pytest.mark.parametrize("flags", [
    ["--head", "d2s", "--norm", "batch-sub2", "--remat"],
    ["--stem", "s2d", "--norm", "none", "--verbose"],
], ids=["d2s_sub2_remat", "s2d_none_verbose"])
def test_train_cli_trains_the_variant_and_the_clis_reload_it(tmp_path, capsys, flags):
    """The train CLI takes the JAX CLI's variant flags and trains on the
    CPU; the checkpoint's config carries them, and evaluate, generate and
    the server rebuild the same model from it."""
    from midi_vae_tpu_torch.cli import evaluate, generate
    from midi_vae_tpu_torch.cli.train import cli as train_cli
    from midi_vae_tpu_torch.io.checkpoint import load_checkpoint
    from midi_vae_tpu_torch.serving.server import InferenceService

    r = train_cli(["--dataset", "vae-lines-synthetic", "--transform-type", "noaug", "--image-size", "32",
                   "--hidden-dims", "8", "16", "--n_features", "4", "--epochs", "1", "--batch-size", "64", "--seed", "0",
                   "--models-dir", str(tmp_path / "m"), "--run-name", "v", "--run-id", "1", "--cpu"] + flags)
    assert np.isfinite(r["train"]["loss"]) and np.isfinite(r["final_test"]["cross-entropy"])
    out = capsys.readouterr().out
    assert ("encode/conv_out shape=(64, 8, 8, 16)" in out) == ("--verbose" in flags)
    ckpt = str(tmp_path / "m" / "vae-lines-synthetic" / "v__1" / "checkpoint_latest.pt")
    cfg = load_checkpoint(ckpt)["config"]
    want = dict(zip([f.lstrip("-") for f in flags[::2]], flags[1::2]))
    assert {k: cfg[k] for k in want} == want and cfg["remat"] == ("--remat" in flags)
    assert cfg["verbose"] == ("--verbose" in flags)
    assert np.isfinite(evaluate.cli(["--checkpoint", ckpt, "--cpu"])["test"]["cross-entropy"])
    images = generate.cli(["--checkpoint", ckpt, "--cpu", "--mode", "interpolate", "--steps", "3",
                           "--out", str(tmp_path / "i.png")])
    assert images.shape == (3, 32, 32, 1) and np.all(np.isfinite(images))
    service = InferenceService(ckpt, device="cpu")
    try:
        trained = r["state"].model
        assert (service.model.stem, service.model.head, service.model.norm) == (trained.stem, trained.head,
                                                                              trained.norm)
        weights = {**trained.state_dict(), **(r["state"].ema_params or {})}
        for name, value in service.model.state_dict().items():
            assert torch.equal(value, weights[name]), name
    finally:
        service.close()
