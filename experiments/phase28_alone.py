"""Phase 28 of ``chip_smoke.py`` alone, on the checkout at ``--root``
(this one by default, or another commit's unpacked copy): build the CUDA
libraries the phase needs, run the phase, and print one JSON line with
the build's seconds, the phase's, and each of its parts'. Run on two
checkouts, one after the other in one call, it compares them on one
machine (ABBA order: parent, change, change, parent).

    python3 experiments/phase28_alone.py [--root DIR]

Each part starts cold, as the phase does not in the full run (cuDNN's
first plans, Triton's first build of the BN phase 2): both sides alike.
"""
import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

PARTS = ("p28_check_dropout", "p28_yolo", "p28_alexnet",
         "p28_dropout_timing", "p28_others", "p28_stream_timing")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.environment import card_info
    from deeplearning4j_tpu_torch.kernels import bn_relu, dropout, lstm
    if not cs.__file__.startswith(root):
        raise SystemExit(f"chip_smoke imported from {cs.__file__}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as ex:
        for f in [ex.submit(bn_relu._phase1_lib), ex.submit(dropout._lib),
                  ex.submit(lstm._lib)]:
            f.result()
    build_s = time.perf_counter() - t0
    parts = {}
    for name in PARTS:
        def timed(*a, _fn=getattr(cs, name), _name=name, **k):
            t = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                parts[_name] = time.perf_counter() - t
        setattr(cs, name, timed)
    t0 = time.perf_counter()
    cs.phase_zoo(torch.device("cuda"), card_info(),
                 torch.cuda.get_device_name(0))
    total = time.perf_counter() - t0
    print(json.dumps({"root": root, "build_s": build_s, "phase28_s": total,
                      "parts_s": parts}), flush=True)


if __name__ == "__main__":
    main()
