"""The benchmark of the PyTorch/CUDA port (``midi_vae_tpu_torch``): one
command runs one cell once (``python3 bench_cuda/run.py --help``)."""
