"""The benchmark's plain references: straightforward PyTorch versions of
what a configuration computes, which the benchmark holds the port's
outputs against. They import nothing of the port."""

import contextlib

import torch


@contextlib.contextmanager
def tf32_off():
    """Full f32 matmuls and convolutions inside, whatever was set outside."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
