"""The optimizers and LR schedules of the PyTorch port against the JAX
package's optax chains, on the CPU in f32.

Each of Adam, SGD, RMSprop, Adagrad, LAMB and Lion (and AdamW, ported
earlier) under each of OneCycle, cosine and step takes 20 updates from the
same parameters on the same gradient sequence on both sides, with an
encoder LR multiplier and weight decay; every parameter is held within
1e-6 relative after every update. One parameter starts at zero, so LAMB's
trust ratio meets a zero norm. The schedules are held to the JAX
package's step for step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from midi_vae_tpu.models.vae import param_group_label as jax_param_group_label
from midi_vae_tpu.train import schedules as jax_schedules
from midi_vae_tpu.train.optim import build_optimizer as jax_build_optimizer
from midi_vae_tpu_torch.models.vae import param_group_label
from midi_vae_tpu_torch.train import schedules
from midi_vae_tpu_torch.train.optim import OPTAX_RULES, build_optimizer, set_step_hyperparams
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# module → parameter → shape: encoder-group and decoder-group names as the models carry them
SHAPES = {"encoder_0": {"kernel": (6, 5), "bias": (5,)}, "fc_mu": {"kernel": (5, 3)},
          "decoder_0": {"kernel": (3, 4), "bias": (4,)}}
STEPS, TOTAL, LR = 20, 30, 0.01


class _Params(nn.Module):
    def __init__(self, tree):
        super().__init__()
        for mod, leaves in tree.items():
            sub = nn.Module()
            for leaf, v in leaves.items():
                sub.register_parameter(leaf, nn.Parameter(torch.from_numpy(np.array(v))))
            self.add_module(mod, sub)


def _tree(rng, zero_bias=False):
    return {mod: {leaf: (np.zeros(s, np.float32) if zero_bias and leaf == "bias" and mod == "encoder_0"
                         else rng.normal(size=s).astype(np.float32)) for leaf, s in leaves.items()}
            for mod, leaves in SHAPES.items()}


@pytest.mark.parametrize("scheduler", ["OneCycle", "cosine", "step"])
@pytest.mark.parametrize("optimizer", ["Adam", "SGD", "RMSprop", "Adagrad", "LAMB", "Lion", "AdamW"])
def test_optimizer_matches_optax(optimizer, scheduler):
    rng = np.random.default_rng(0)
    params = _tree(rng, zero_bias=True)
    grads = [_tree(rng) for _ in range(STEPS)]
    kw = dict(optimizer=optimizer, lr=LR, scheduler=scheduler, total_steps=TOTAL, lr_encoder_mult=0.5,
              weight_decay=1e-2)

    tx = jax_build_optimizer(None, jax_param_group_label, **kw).tx
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    update = jax.jit(tx.update)

    model = _Params(params)
    bundle = build_optimizer(model, param_group_label, **kw)
    assert (optimizer.lower() in OPTAX_RULES) != isinstance(bundle.optimizer, torch.optim.AdamW)
    named = dict(model.named_parameters())
    for step, g in enumerate(grads):
        updates, opt_state = update(jax.tree_util.tree_map(jnp.asarray, g), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, p in named.items():
            mod, leaf = name.split(".")
            p.grad = torch.from_numpy(g[mod][leaf])
        set_step_hyperparams(bundle, step)
        bundle.optimizer.step()
        for name, p in named.items():
            mod, leaf = name.split(".")
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[mod][leaf]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"{name} after update {step + 1}")


@pytest.mark.parametrize("name,kw", [
    ("cosine", dict(total_steps=40)), ("step", dict(total_steps=40, step_size=7, gamma=0.5)),
    ("step", dict(total_steps=40)),
], ids=["cosine", "step_7", "step_default"])
def test_lr_schedules_match_jax(name, kw):
    port, ref = schedules.lr_schedule(name, 0.003, **kw), jax_schedules.lr_schedule(name, 0.003, **kw)
    for s in range(60):
        np.testing.assert_allclose(port(s), float(ref(jnp.int32(s))), rtol=1e-6, atol=0, err_msg=f"step {s}")


def test_only_the_adam_family_and_sgd_take_the_cycled_beta1():
    """OneCycle's β1 counter-cycle drives adamw, adam and sgd, as the JAX
    package injects ``b1`` into those three only; SGD has no momentum
    without it, as optax's sgd."""
    model = _Params(_tree(np.random.default_rng(0)))
    for name in ("AdamW", "Adam", "SGD", "RMSprop", "Adagrad", "LAMB", "Lion"):
        for scheduler in ("OneCycle", "cosine"):
            bundle = build_optimizer(model, param_group_label, optimizer=name, scheduler=scheduler, total_steps=TOTAL)
            cycled = scheduler == "OneCycle" and name.lower() in ("adamw", "adam", "sgd")
            assert (bundle.b1_schedule is not None) == cycled, (name, scheduler)
    sgd = build_optimizer(model, param_group_label, optimizer="SGD", scheduler="cosine", total_steps=TOTAL)
    assert all(g["b1"] is None for g in sgd.optimizer.param_groups)
    with pytest.raises(ValueError, match="Unsupported optimizer"):
        build_optimizer(model, param_group_label, optimizer="Adafactor")
    with pytest.raises(NotImplementedError, match="not supported"):
        schedules.lr_schedule("exponential", 0.1, 10)


def test_optimizer_state_round_trips_through_its_state_dict():
    """A resumed run restores an optax-rule optimizer's state exactly."""
    rng = np.random.default_rng(1)
    params, grads = _tree(rng), [_tree(rng) for _ in range(4)]

    def run(split):
        model = _Params(params)
        bundle = build_optimizer(model, param_group_label, optimizer="LAMB", lr=LR, total_steps=TOTAL)
        for step, g in enumerate(grads):
            if step == split:
                saved = bundle.optimizer.state_dict()
                model2 = _Params({m: {k: v.detach().numpy() for k, v in mod.named_parameters()}
                                  for m, mod in model.named_children()})
                bundle = build_optimizer(model2, param_group_label, optimizer="LAMB", lr=LR, total_steps=TOTAL)
                bundle.optimizer.load_state_dict(saved)
                model = model2
            for name, p in model.named_parameters():
                mod, leaf = name.split(".")
                p.grad = torch.from_numpy(g[mod][leaf])
            set_step_hyperparams(bundle, step)
            bundle.optimizer.step()
        return {n: p.detach().clone() for n, p in model.named_parameters()}

    a, b = run(None), run(2)
    assert all(torch.equal(a[n], b[n]) for n in a)
