"""End-to-end walkthrough of the PyTorch port: synthetic MIDI corpus → train
→ generate → export .mid → interpolate → serve over HTTP.

The twin of ``examples/end_to_end.py`` on the port's public API
(``midi_vae_tpu_torch``), with the same flags. It runs on the GPU; pass
``--cpu`` to run it on the CPU::

    python examples/torch_end_to_end.py --workdir /tmp/e2e_torch          # the GPU
    python examples/torch_end_to_end.py --workdir /tmp/e2e_torch --cpu    # the CPU

Read it top to bottom as the API tour.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--workdir", default="/tmp/midi_vae_torch_e2e")
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--n-files", type=int, default=64)
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args()
    device = "cpu" if args.cpu else "cuda"
    device_flag = ["--cpu"] if args.cpu else []

    # 1. a synthetic .mid corpus (midi/factory.py: the MIDI analog of the
    #    reference's PNG line-image factory)
    from midi_vae_tpu_torch.midi.factory import generate_midi_dataset

    # dataset names starting with "midi" route to the .mid-folder loader
    corpus = os.path.join(args.workdir, "midi-example")
    if not os.path.isdir(corpus):
        n = generate_midi_dataset(args.n_files, corpus, seed=0)
        print(f"[1] wrote {n} .mid files under {corpus}")

    # 2. train: the corpus parses (native C++, built at first use),
    #    rasterizes to piano-roll windows, caches as RRD, and feeds the loop
    from midi_vae_tpu_torch.train.config import TrainConfig
    from midi_vae_tpu_torch.train.loop import run

    config = TrainConfig(
        dataset_name=os.path.basename(corpus),
        data_dir=os.path.dirname(corpus),
        transform_type="pianoroll",
        image_size=128,
        n_features=10,
        kld_weight=0.00025,
        kl_schedule="linear",
        kl_warmup_steps=200,
        epochs=args.epochs,
        batch_size_per_device=32,
        seed=0,
        models_dir=os.path.join(args.workdir, "models"),
        log_images=False,
    )
    results = run(config, device=device)
    print(f"[2] trained {args.epochs} epochs on {device}; final test metrics:",
          {k: round(v, 4) for k, v in results["final_test"].items() if isinstance(v, float)})

    # 3. generate: prior samples as a PNG grid + playable .mid export
    from midi_vae_tpu_torch.cli.generate import cli as generate_cli

    grid = os.path.join(args.workdir, "samples.png")
    mids = os.path.join(args.workdir, "generated_midi")
    generate_cli(["--checkpoint", config.checkpoint_path, "--mode", "sample", "-n", "8",
                  "--out", grid, "--export-midi", mids, *device_flag])
    print(f"[3] samples: {grid}; playable files: {mids}/")

    # 4. latent interpolation between two real rolls
    interp = os.path.join(args.workdir, "interpolation.png")
    generate_cli(["--checkpoint", config.checkpoint_path, "--mode", "interpolate",
                  "--data-dir", args.workdir, "--steps", "8", "--slerp", "--out", interp, *device_flag])
    print(f"[4] interpolation path: {interp}")

    # 5. serve the checkpoint over HTTP and hit it with the in-tree client
    #    (binary npy wire, the production path; wire="json" for debugging)
    from midi_vae_tpu_torch.serving.client import ServingClient
    from midi_vae_tpu_torch.serving.server import serve

    httpd = serve(config.checkpoint_path, port=0, device=device)
    try:
        client = ServingClient(f"http://127.0.0.1:{httpd.server_address[1]}")
        served = client.sample(2, seed=0)
        recon = client.reconstruct(served)
        health = client.healthz()
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.service.close()
    print(f"[5] served {len(served)} samples + {len(recon)} reconstructions "
          f"over the npy wire; health: {health}")


if __name__ == "__main__":
    main()
