"""Which kernels' machine code an edit of csrc/ changed: every CUDA library
of the port built from this checkout and from another, side by side, and
each kernel's SASS compared.

    python3 experiments/sass_diff.py --parent DIR

DIR holds ``deeplearning4j_tpu_torch/csrc/`` of the other commit
(``git archive <commit> deeplearning4j_tpu_torch/csrc | tar -x -C DIR``).
Every library is built by the port's nvcc command, the other commit's
with its own directory on the include path, all builds started together,
into deeplearning4j_tpu_torch/_build/sass_diff/. A kernel is matched by
its mangled name with the anonymous namespace's hash taken out (it
changes with the source's text), and its SASS is compared without the
instructions' addresses. Prints, a library at a time, how many kernels
are identical and, for each that differs, its registers and spills
(ptxas's report) and SASS lines on both sides; a library whose source
one side lacks is named and skipped. Needs the CUDA toolkit; no card.
"""
import argparse
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from deeplearning4j_tpu_torch.kernels import _cuda  # noqa: E402
from deeplearning4j_tpu_torch.kernels import measure  # noqa: E402

OUT = os.path.join(_cuda.PACKAGE, "_build", "sass_diff")
LIBS = ("attention_f32", "bn_bwd_reduce", "causal_attention", "dropout",
        "int8_matmul", "lstm_recurrence", "paged_attention",
        # the GRU, Graves and simple RNN cells' first design, which the
        # recurrence engine (lstm_recurrence) replaced: a parent tree from
        # before the engine holds it, this tree does not
        "rnn_recurrence")


def _name(mangled):
    return re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", mangled)


def _code(sass):
    """A kernel's instructions without their addresses."""
    return [re.sub(r"/\*[0-9a-f]{4,}\*/", "", ln).strip()
            for ln in sass.splitlines()
            if ln.strip() and "headerflags" not in ln]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="a checkout holding "
                    "deeplearning4j_tpu_torch/csrc/ of the other commit")
    csrc = {"this": _cuda.CSRC,
            "parent": os.path.join(ap.parse_args().parent,
                                   "deeplearning4j_tpu_torch", "csrc")}
    os.makedirs(OUT, exist_ok=True)
    nvcc, procs = _cuda.nvcc(), {}
    for side, d in csrc.items():
        for lib in LIBS:
            if not os.path.exists(_cuda.source(lib, d)):
                continue
            so = os.path.join(OUT, f"{side}_{lib}.so")
            cmd = [nvcc, *_cuda.NVCC_FLAGS, "-I", d, "-o", so,
                   _cuda.source(lib, d)]
            procs[side, lib] = so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    built, failed = {}, []
    for key, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"{key}: nvcc failed\n{log[-3000:]}")
            continue
        use, spills = measure.ptxas_usage(log), measure.ptxas_spills(log)
        built[key] = {_name(fn): (_code(body), use.get(fn), spills.get(fn))
                      for fn, body in measure.sass_kernels(so).items()}
    if failed:
        raise SystemExit("\n".join(failed))
    for lib in LIBS:
        if ("this", lib) not in built or ("parent", lib) not in built:
            print(f"{lib}: not on both sides, not compared", flush=True)
            continue
        this, parent = built["this", lib], built["parent", lib]
        same = 0
        for fn in sorted(set(this) | set(parent)):
            a, b = this.get(fn), parent.get(fn)
            if a and b and a[0] == b[0]:
                same += 1
                continue
            side = lambda k: (f"{k[1]} registers/smem, spills {k[2]}, "
                              f"{len(k[0])} lines" if k else "absent")
            print(f"  {lib}: {fn[:100]} differs: this {side(a)}; parent "
                  f"{side(b)}")
        print(f"{lib}: {same} of {len(set(this) | set(parent))} kernels "
              f"with identical SASS", flush=True)


if __name__ == "__main__":
    main()
