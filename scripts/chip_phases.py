"""Phases 8a, 8b and 9a of one checkout's ``chip_smoke.py``, on one card.

    python3 scripts/chip_phases.py CHECKOUT

Runs the serving (8a), LM serving (8b) and training (9a) phases of the
``chip_smoke.py`` in ``CHECKOUT`` (a ``git archive`` unpacked somewhere)
against that checkout's own ``src/``, with its kernels built first. Run
it for a parent and a change in turns within one call (parent, change,
change, parent) to compare their end-to-end figures on one card; each
run is a process of its own.
"""
import os
import sys

tree = os.path.abspath(sys.argv[1])
sys.path[:0] = [os.path.join(tree, "src"), tree]
os.chdir(tree)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

if not cs.__file__.startswith(tree):
    raise SystemExit(f"chip_smoke imported from {cs.__file__}, not {tree}")
_build.build_all()
print("subset tree", tree, flush=True)
kernels = cs.all_kernels()
cs.serving_service(kernels)
torch.cuda.empty_cache()
cs.serving_lm()
cs.training_full_width(kernels)
print("subset done", flush=True)
