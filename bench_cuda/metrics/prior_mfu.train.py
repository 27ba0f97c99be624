"""The stage-2 prior's step against the card's peak: ``mfu.train``'s
reading (model FLOPs a step, ``flops_per_step``, here from
``bench_cuda/counts_prior.py``, times the window's steps over the
window's seconds over the peak of the configuration's dtype, in %), taken
from ``mfu.train.py`` itself for the cells that ``mfu.train`` does not
list."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "bench_cuda_metric_mfu_train", os.path.join(os.path.dirname(os.path.abspath(__file__)), "mfu.train.py"))
_mfu = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mfu)
read = _mfu.read
