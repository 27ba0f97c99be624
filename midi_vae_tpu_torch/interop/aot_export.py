"""The exported serving artifact (counterpart of
``midi_vae_tpu/interop/aot_export.py``).

``torch.export`` captures a model's serving computations as
``ExportedProgram``s, weights included, which a deployment process loads
with ``torch.export.load`` and runs without this package's model code or
a checkpoint. A program exported for ``cuda`` calls the fused BatchNorm's
operators (``ops/fused_norm.py``) and, for a VQ model, the quantizer's
search (``ops/vq_search.py``), which loading it needs registered:
importing this module registers them. Programs, as in the JAX package (``serving/server.py``
semantics):

- ``reconstruct``: x → the posterior-mean decode (encode → mu → decode);
- ``encode``: x → ``[mu | log_var]``;
- ``decode``: z → image probabilities (the caller draws z);

each taking the int labels ``y`` too for a conditional checkpoint. With a
trained code prior (``--prior``, VQ checkpoints) two more:

- ``prior_logits``: the prior's full-grid forward, codes [b, s, s] (and a
  class-conditional prior's labels) → next-code logits [b, s, s, K];
- ``decode_indices``: the VQ model's code grid → image probabilities.

JAX exports the two-stage sampler as one ``lax.scan`` program; unrolled
here it would be s² prior forwards in one graph, so the position loop and
the draw stay in the loader (:meth:`AOTServingBundle.sample`), which runs
``core/sampling.py`` ``sample_codes_autoregressive``, the checkpoint
server's sampler, over the exported prior: the same ``torch.Generator`` on
the serving device keyed by the seed, the same order of draws,
temperature at run time and ``top_p`` baked into the manifest, as JAX
bakes it.

The batch dimension is symbolic (``Dim("b")``): one program serves every
batch size. A program holds device constants, so it is exported once per
device type asked for (``--platforms cuda cpu``), into
``<platform>/<name>.pt2`` (``torch.export.save``); exporting for ``cuda``
needs the card, for ``cpu`` it does not. ``manifest.json`` carries the
JAX manifest's keys: ``format`` names ``torch.export``, ``platforms`` the
device types exported for, and ``torch_version`` takes the place of
``calling_convention_version``. The programs are not compiled ahead of
time (AOTInductor): they run eagerly, op by op, as the live model does.

:class:`AOTServingBundle` loads a directory with torch,
``ops/fused_norm.py`` and ``ops/vq_search.py`` alone (no module of
``midi_vae_tpu_torch.models``) and validates the manifest at load: a
serving device type the artifact was not exported for, or a torch older
than the exporter's, raises before any request.

CLI::

    python -m midi_vae_tpu_torch.interop.aot_export --checkpoint CKPT --out DIR \\
        [--platforms cuda cpu] [--prior PRIOR [--top-p P]] [--no-ema] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from midi_vae_tpu_torch.core.device import DeviceLike, resolve_device
from midi_vae_tpu_torch.core.sampling import sample_codes_autoregressive
from midi_vae_tpu_torch.ops import fused_norm, vq_search  # noqa: F401  (register the operators a cuda program calls)

MANIFEST_NAME = "manifest.json"
ARTIFACT_SUFFIX = ".pt2"
FORMAT = "torch.export ExportedProgram (torch.export.save)"
EXAMPLE_BATCH = 2  # the traced batch; the exported one is symbolic


# ----------------------------------------------------------------- export


class _Reconstruct(nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x, y=None):
        yk = {} if y is None else {"y": y}
        return self.model.decode(self.model.encode(x, train=False, **yk).mu, train=False, **yk)


class _Encode(_Reconstruct):
    def forward(self, x, y=None):
        enc = self.model.encode(x, train=False, **({} if y is None else {"y": y}))
        return torch.cat([enc.mu, enc.log_var], dim=-1)


class _Decode(_Reconstruct):
    def forward(self, z, y=None):
        return self.model.decode(z, train=False, **({} if y is None else {"y": y}))


class _DecodeIndices(_Reconstruct):
    def forward(self, idx):
        return self.model.decode_indices(idx)


class _PriorLogits(_Reconstruct):
    def forward(self, idx, y=None):
        return self.model(idx, y)


def _programs(model, prior, conditional: bool, image_size: int, channels: int):
    """name → (module, example-input builder (device → args))."""
    latent_dim = int(getattr(model, "flat_latent_dim", model.latent_dim))
    b = EXAMPLE_BATCH

    def with_y(args, dev):
        return args + ((torch.zeros(b, dtype=torch.long, device=dev),) if conditional else ())

    progs = {
        "reconstruct": (_Reconstruct(model), lambda dev: with_y((torch.zeros(b, image_size, image_size, channels,
                                                                             device=dev),), dev)),
        "encode": (_Encode(model), lambda dev: with_y((torch.zeros(b, image_size, image_size, channels,
                                                                   device=dev),), dev)),
        "decode": (_Decode(model), lambda dev: with_y((torch.zeros(b, latent_dim, device=dev),), dev)),
    }
    if prior is not None:
        s = model.last_conv_size
        prior_conditional = int(getattr(prior, "num_classes", 0) or 0) > 0

        def codes(dev):
            return torch.zeros(b, s, s, dtype=torch.long, device=dev)

        progs["prior_logits"] = (_PriorLogits(prior), lambda dev: (codes(dev),) + (
            (torch.zeros(b, dtype=torch.long, device=dev),) if prior_conditional else ()))
        progs["decode_indices"] = (_DecodeIndices(model), lambda dev: (codes(dev),))
    return progs


def export_serving_programs(
    model,
    out_dir: str,
    *,
    image_size: int,
    channels: int,
    platforms: Optional[Sequence[str]] = None,
    prior=None,
    prior_config: Optional[dict] = None,
    prior_top_p: Optional[float] = None,
) -> dict:
    """Export the serving programs of ``model`` (an eval-ready model of this
    package) to ``out_dir``; returns the manifest. ``platforms``: device
    types to export for (default: the model's own); each gets its own copy
    of every program. A code prior (VQ models only) adds ``prior_logits``
    and ``decode_indices`` for the loader's two-stage sampler."""
    from torch.export import Dim, export, save

    if prior is not None and getattr(model, "latent_kind", "gaussian") != "vq":
        raise ValueError("prior export applies to VQ checkpoints only")
    home = next(model.parameters()).device
    platforms = list(platforms) if platforms else [home.type]
    conditional = int(getattr(model, "num_classes", 0) or 0) > 0
    progs = _programs(model, prior, conditional, image_size, channels)
    prior_meta = None
    if prior is not None:
        pcfg = prior_config or {}
        prior_meta = {
            "arch": str(pcfg.get("arch") or "pixelcnn"),
            "num_classes": int(pcfg.get("num_classes") or 0),
            "num_codes": int(prior.num_codes),
            "grid": int(model.last_conv_size),
            "test_nll": pcfg.get("test_nll"),
            "top_p": prior_top_p,  # baked sampling rule (null = unrestricted)
        }
    manifest = {
        "format": FORMAT,
        "programs": {name: {"files": {}, "bytes": {}, "export_s": {}} for name in progs},
        "conditional": conditional,
        "num_classes": int(getattr(model, "num_classes", 0) or 0),
        "image_size": int(image_size),
        "channels": int(channels),
        "latent_dim": int(getattr(model, "flat_latent_dim", model.latent_dim)),
        "latent_kind": getattr(model, "latent_kind", "gaussian"),
        "model": type(model).__name__,
        "prior": prior_meta,
        "platforms": platforms,
        "torch_version": torch.__version__,
    }
    b = Dim("b")
    for platform in platforms:
        dev = resolve_device(platform)
        os.makedirs(os.path.join(out_dir, dev.type), exist_ok=True)
        for name, (module, example) in progs.items():
            module.to(dev)
            args = example(dev)
            t0 = time.perf_counter()
            with torch.no_grad():
                program = export(module, args, dynamic_shapes=tuple({0: b} for _ in args))
            rel = os.path.join(dev.type, name + ARTIFACT_SUFFIX)
            save(program, os.path.join(out_dir, rel))
            rec = manifest["programs"][name]
            rec["files"][dev.type] = rel
            rec["bytes"][dev.type] = os.path.getsize(os.path.join(out_dir, rel))
            rec["export_s"][dev.type] = time.perf_counter() - t0
            rec["in_shapes"] = [["b", *map(int, a.shape[1:])] for a in args]
            rec["in_dtypes"] = [str(a.dtype).removeprefix("torch.") for a in args]
    model.to(home)
    if prior is not None:
        prior.to(home)
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


# ------------------------------------------------------------------- load


def _version(v: str) -> tuple:
    """(major, minor, patch) of a torch version string such as ``2.11.0+cu128``."""
    return tuple(int(p) for p in re.findall(r"\d+", v.split("+")[0])[:3])


class AOTServingBundle:
    """An exported directory, loaded onto ``device`` (the GPU unless the
    caller asks for the CPU); needs torch, ``ops/fused_norm.py`` and
    ``ops/vq_search.py`` only. Programs are attributes:
    ``bundle.reconstruct(x[, y])``, ``encode``, ``decode`` and, for an
    artifact exported with a prior, ``sample(seed, temperature, y)`` and
    ``sample_codes`` (the same draw, before the decode). They take numpy
    arrays or tensors and return tensors on the device."""

    def __init__(self, artifact_dir: str, device: DeviceLike = "cuda"):
        with open(os.path.join(artifact_dir, MANIFEST_NAME)) as f:
            self.manifest = json.load(f)
        self.device = resolve_device(device)
        self._validate_manifest()
        self.artifact_dir = artifact_dir
        self.conditional = bool(self.manifest["conditional"])
        self.num_classes = int(self.manifest.get("num_classes", 0))
        self.prior = self.manifest.get("prior")
        self._modules = {}
        for name, rec in self.manifest["programs"].items():
            program = torch.export.load(os.path.join(artifact_dir, rec["files"][self.device.type]))
            self._modules[name] = program.module()
        for name in ("reconstruct", "encode", "decode"):
            setattr(self, name, self._wrap(self._modules[name]))
        if "prior_logits" in self._modules:
            self.sample = self._sample
            self.sample_codes = self._sample_codes

    def _validate_manifest(self) -> None:
        """Fail at load, not at the first request: a server must not start
        on an artifact it cannot run."""
        m = self.manifest
        platforms = [p.lower() for p in m.get("platforms", [])]
        if self.device.type not in platforms:
            raise ValueError(
                f"artifact was exported for platforms {platforms} but the serving device is "
                f"'{self.device.type}' — re-export with --platforms {self.device.type} "
                "(multi-platform artifacts list every target)"
            )
        exported_with = m.get("torch_version", "0")
        if _version(torch.__version__) < _version(exported_with):
            raise ValueError(
                f"artifact was exported with torch {exported_with}, but this torch is "
                f"{torch.__version__} — upgrade torch on the serving box or re-export with the older torch"
            )

    def _args(self, args) -> list:
        out = []
        for a in args:
            t = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
            t = t.to(torch.long) if not t.is_floating_point() else t.to(torch.float32)
            out.append(t.to(self.device))
        return out

    def _wrap(self, module):
        def call(*args):
            with torch.inference_mode():
                return module(*self._args(args))

        return call

    def _sample(self, seed: int, temperature: float, y) -> torch.Tensor:
        """The two-stage sampler: :meth:`sample_codes`, then the exported
        ``decode_indices``; [len(y), H, W, C]."""
        idx = self._sample_codes(seed, temperature, y)
        with torch.inference_mode():
            return self._modules["decode_indices"](idx.long())

    def _sample_codes(self, seed: int, temperature: float, y) -> torch.Tensor:
        """Ancestral code draws [len(y), s, s] (int32): ``core/sampling.py``
        ``sample_codes_autoregressive`` over the exported ``prior_logits``,
        so a seed draws the codes the checkpoint server draws. ``y``
        carries the batch size (its values matter only to a
        class-conditional prior)."""
        (y,) = self._args([y])
        logits_of = self._modules["prior_logits"]
        conditional = int(self.prior.get("num_classes") or 0) > 0

        def prior(idx, labels):
            return logits_of(idx, labels) if conditional else logits_of(idx)

        return sample_codes_autoregressive(prior, seed, len(y), int(self.prior["grid"]), temperature, y=y,
                                           top_p=self.prior.get("top_p"), device=self.device,
                                           num_codes=int(self.prior["num_codes"]))


# -------------------------------------------------------------------- CLI


def main(argv: Optional[list] = None) -> dict:
    parser = argparse.ArgumentParser(description="Export a checkpoint's serving programs with torch.export")
    parser.add_argument("--checkpoint", required=True, help="Checkpoint to export (.pt of this package)")
    parser.add_argument("--out", required=True, help="Output directory for the artifacts")
    parser.add_argument("--platforms", nargs="+", default=None, choices=("cuda", "cpu"),
                        help="Device types to export for (e.g. cuda cpu). Default: cuda, or cpu with --cpu. "
                             "Multi-platform artifacts run on any listed device type.")
    parser.add_argument("--prior", metavar="PATH", default=None,
                        help="Trained code prior (cli/train_prior.py) to bake into the artifact (VQ "
                             "checkpoints only): the loader then answers /sample with the two-stage sampler")
    parser.add_argument("--top-p", type=float, default=None,
                        help="Bake nucleus sampling into the two-stage sampler (needs --prior); recorded "
                             "in the manifest's prior.top_p")
    parser.add_argument("--no-ema", action="store_true", help="Export the raw (non-averaged) parameters")
    parser.add_argument("--cpu", action="store_true", help="Load on the CPU and export for it by default")
    args = parser.parse_args(argv)
    if args.top_p is not None:
        if args.prior is None:
            raise SystemExit("--top-p bakes the nucleus rule into the two-stage sampler; it needs --prior")
        if not (0.0 < args.top_p <= 1.0):
            raise SystemExit(f"--top-p must be in (0, 1], got {args.top_p}")

    from midi_vae_tpu_torch.cli.generate import _load_model_and_state

    device = "cpu" if args.cpu else "cuda"
    model, _, image_size, channels, _ = _load_model_and_state(args.checkpoint, use_ema=not args.no_ema, device=device)
    prior = prior_config = None
    if args.prior is not None:
        from midi_vae_tpu_torch.cli.train_prior import load_prior

        prior, prior_config = load_prior(args.prior, device=device)
        if (int(prior_config["num_codes"]) != int(getattr(model, "codebook_size", -1))
                or int(prior_config["grid"]) != getattr(model, "last_conv_size", -1)):
            raise SystemExit(
                f"prior geometry (K={prior_config['num_codes']}, grid={prior_config['grid']}) "
                "does not match the checkpoint"
            )
    manifest = export_serving_programs(
        model, args.out, image_size=image_size, channels=channels, platforms=args.platforms or [device],
        prior=prior, prior_config=prior_config, prior_top_p=args.top_p,
    )
    total = sum(sum(p["bytes"].values()) for p in manifest["programs"].values())
    print(f"exported {len(manifest['programs'])} programs ({total / 1e6:.2f} MB) for platforms "
          f"{manifest['platforms']} to {args.out}")
    return manifest


if __name__ == "__main__":
    main()
