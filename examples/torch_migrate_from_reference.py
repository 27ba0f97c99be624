"""Migration walkthrough on the PyTorch port: carry trained torch-vae weights
into ``midi_vae_tpu_torch`` and keep training them.

The twin of ``examples/migrate_from_torch.py`` on the port's public API,
with the same flags. For a user of the PyTorch reference
(``finlaymiller/torch-vae``): take a reference checkpoint's ``state_dict``,
import it into the port's model, check that the port's forward gives the
reference's, then continue training with the port's train step. It runs on
the GPU; pass ``--cpu`` to run it on the CPU::

    python examples/torch_migrate_from_reference.py          # the GPU
    python examples/torch_migrate_from_reference.py --cpu    # the CPU

Steps:
1. Build the reference-architecture torch model (here freshly initialised;
   point ``--checkpoint`` at a real reference ``.pt`` to migrate actual
   training state: keys in the reference's ``encoder``/``decoder``
   state-dict layout, utils.py:344-345).
2. ``midi_vae_tpu_torch.interop.import_reference_state_dict`` into the
   port's ``VanillaVAE(torch_compat=True)``.
3. Forward parity on the same inputs and noise, within 1e-4 (TF32 off).
4. Continue training with the port's train step (AdamW, a constant rate):
   the loss falls from the migrated weights.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks"))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", default=None,
                        help="Optional reference checkpoint (.pt). Its encoder/decoder "
                             "state dicts are merged and imported; default: fresh torch init.")
    parser.add_argument("--image-size", type=int, default=32)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args()

    import torch

    from midi_vae_tpu_torch.core.device import resolve_device
    from midi_vae_tpu_torch.data.synthetic import generate_line_images
    from midi_vae_tpu_torch.interop import import_reference_state_dict
    from midi_vae_tpu_torch.losses.schedules import kl_weight_schedule
    from midi_vae_tpu_torch.models.registry import build_model
    from midi_vae_tpu_torch.models.vae import param_group_label
    from midi_vae_tpu_torch.train.optim import build_optimizer
    from midi_vae_tpu_torch.train.state import create_train_state, make_train_step
    from torch_cpu_baseline import TorchRefVAE

    device = resolve_device("cpu" if args.cpu else "cuda")
    torch.backends.cudnn.allow_tf32 = False  # f32 on the card is f32 for the parity check
    torch.backends.cuda.matmul.allow_tf32 = False
    hid = (32, 64, 128, 256)

    # 1. The torch side -----------------------------------------------------
    torch.manual_seed(0)
    tmodel = TorchRefVAE(in_ch=1, latent=10, input_dim=args.image_size, hidden=hid)
    if args.checkpoint:
        payload = torch.load(args.checkpoint, map_location="cpu", weights_only=False)
        sd = {**payload["encoder"], **payload["decoder"]}  # reference layout (utils.py:344-345)
        tmodel.load_state_dict(sd)
        print(f"loaded reference checkpoint '{args.checkpoint}' (epoch {payload.get('epoch')})")
    tmodel.eval()

    # 2. Import into the port -------------------------------------------------
    model = build_model("VanillaVAE", in_channels=1, latent_dim=10, input_dim=args.image_size, hidden_dims=hid,
                        torch_compat=True, device=device)
    import_reference_state_dict(model, tmodel.state_dict())
    model.eval()

    # 3. Forward parity on real inputs --------------------------------------
    x = np.random.default_rng(0).uniform(0, 1, (8, 1, args.image_size, args.image_size)).astype(np.float32)
    eps = np.random.default_rng(1).standard_normal((8, 10)).astype(np.float32)
    with torch.no_grad():
        recon_t, _, _ = tmodel(torch.from_numpy(x), eps=torch.from_numpy(eps))
        enc = model.encode(torch.from_numpy(x.transpose(0, 2, 3, 1)).to(device))
        z = enc.mu + torch.from_numpy(eps).to(device) * torch.exp(0.5 * enc.log_var)
        recon_p = model.decode(z).permute(0, 3, 1, 2).cpu()
    err = float((recon_p - recon_t).abs().max())
    print(f"forward parity on {device}: max |reference - port| = {err:.2e}  (expect < 1e-4)")
    if not err < 1e-4:
        raise SystemExit("imported weights do not reproduce the reference forward pass")

    # 4. Continue training with the port's train step -----------------------
    model.train()
    bundle = build_optimizer(model, param_group_label, lr=1e-3, weight_decay=1e-5, scheduler="constant")
    state = create_train_state(model, bundle)
    step = make_train_step(kl_weight_schedule("constant", 2.5e-4))

    images, _ = generate_line_images(512, img_size=(args.image_size, args.image_size), max_lines=3, seed=0)
    data = torch.from_numpy(images.astype(np.float32) / 255.0)[..., None].to(device)
    first = last = None
    for i in range(args.steps):
        lo = (i * 64) % (len(data) - 64)
        state, loss, _ = step(state, data[lo : lo + 64], 0)
        if i == 0:
            first = float(loss.loss)
        last = float(loss.loss)
    print(f"continued training {args.steps} steps with the port's train step on {device}: "
          f"loss {first:.4f} -> {last:.4f}")
    if not last < first:
        raise SystemExit("loss did not decrease from the migrated weights")
    print("migration OK")


if __name__ == "__main__":
    main()
