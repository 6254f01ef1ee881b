"""Some phases of one checkout's ``chip_smoke.py``, on one card.

    python3 scripts/chip_phases.py CHECKOUT [NAME=INT ...] [PHASE ...]

Runs the named phases of the ``chip_smoke.py`` in ``CHECKOUT`` (a ``git
archive`` unpacked somewhere, or the repository itself) against that
checkout's own ``src/``, with its kernels built first: ``8a`` serving,
``8b`` LM serving, ``8c`` MoE and MLA serving, ``8d`` the recurrent
mixers' serving, ``8e`` the encoder-decoder and VLM serving, ``9a``
training, ``9c`` MoE training, ``9d`` RWKV training, ``9e`` whisper
training, ``9f`` MoE training on a mesh of four gloo ranks and, in the
same spawn, ``9g``'s every family on that mesh (``9g`` alone runs 9g
only), ``10lm`` phase 10's census of the LM runs, ``10rec`` its
recurrent runs only, ``10enc`` its encoder-decoder and VLM runs only; by
default 8a, 8b and 9a. ``NAME=INT`` sets one of the script's integer constants
first (``MOE_TRAIN_LAYERS=14`` trains 14 layers in 9c). Run it for a parent and a change in turns within one call
(parent, change, change, parent) to compare their end-to-end figures on
one card; each run is a process of its own.
"""
import os
import sys


def main():
    tree = os.path.abspath(sys.argv[1])
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    os.chdir(tree)

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build

    if not cs.__file__.startswith(tree):
        raise SystemExit(f"chip_smoke imported from {cs.__file__}, not {tree}")
    _build.build_all()
    print("subset tree", tree, flush=True)
    kernels = cs.all_kernels()
    phases = {"8a": lambda: cs.serving_service(kernels), "8b": cs.serving_lm,
              "8c": cs.serving_moe, "8d": cs.serving_recurrent, "8e": cs.serving_encdec,
              "9a": lambda: cs.training_full_width(kernels), "9c": cs.training_moe,
              "9d": cs.training_recurrent, "9e": cs.training_encdec,
              "9f": cs.training_mesh,
              "9g": lambda: cs.training_mesh(olmoe=False),
              "10lm": lambda: cs.lm_census({}), "10rec": lambda: cs.recurrent_census({}),
              "10enc": lambda: cs.encdec_census({})}
    args = sys.argv[2:]
    for arg in [a for a in args if "=" in a]:
        name, value = arg.split("=")
        if not isinstance(getattr(cs, name), int):
            raise SystemExit(f"{name} is not an integer constant of chip_smoke.py")
        setattr(cs, name, int(value))
        print(f"subset {name}={value}", flush=True)
    for name in [a for a in args if "=" not in a] or ["8a", "8b", "9a"]:
        phases[name]()
        torch.cuda.empty_cache()
    print("subset done", flush=True)


# phase 9f spawns its ranks, which import this file again
if __name__ == "__main__":
    main()
