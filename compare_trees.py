"""Two trees on one card, in the order parent, change, change, parent.

Usage, from the repository root on a machine with the GPU::

    git archive <parent> | tar -x -C build/parent
    python3 compare_trees.py TAG [CHANGE_ROOT]

Per tree, in processes of their own: ``chip_smoke.py --kernel-times --src
<tree>/src`` (the change's script: ``quantize_layout`` per ResNet-18 b16
and b1 forward, and the other redesigned kernels) and the tree's own
phase 27 (``executable_phase``: replays, busy time by wrapper, the kernels
of a b16 replay).  The lines go to standard output and to
``chiprun_out/TAG_summary.txt``; each process's standard error to
``chiprun_out/``.  The parent is ``build/parent``; the change this
checkout, or CHANGE_ROOT.
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
TAG = sys.argv[1] if len(sys.argv) > 1 else "cmp"
SIDE27 = r'''
import sys
root = sys.argv[1]
sys.path.insert(0, root); sys.path.insert(0, root + "/src")
import torch
import chip_smoke as cs
from repro_torch import api
from repro_torch.kernels import _build
from concurrent.futures import ThreadPoolExecutor
with ThreadPoolExecutor(len(_build.SOURCES)) as pool:
    list(pool.map(_build.build, _build.SOURCES))
xp = cs.executable_phase(api, torch.device("cuda"))
print(cs.executable_line(xp, cs.nvidia_smi()), flush=True)
'''
out = os.path.join(ROOT, "chiprun_out")
os.makedirs(out, exist_ok=True)
parent = os.path.join(ROOT, "build", "parent")
change = sys.argv[2] if len(sys.argv) > 2 else ROOT
summary = open(os.path.join(out, f"{TAG}_summary.txt"), "w")
_print = print
def print(*a, **k):
    _print(*a, **k)
    _print(*a, **{**k, "file": summary})
for i, (label, root) in enumerate((("parent", parent), ("change", change),
                                   ("change", change), ("parent", parent))):
    p = subprocess.run([sys.executable, os.path.join(change, "chip_smoke.py"), "--kernel-times",
                        "--src", os.path.join(root, "src"), "--label", label],
                       capture_output=True, text=True, timeout=900, cwd=ROOT)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("[times") or ln.startswith("{")]
    print(f"{i} {label} kernel-times rc={p.returncode}:", *lines[-4:], sep="\n  ", flush=True)
    if p.returncode:
        print(p.stderr[-2000:], flush=True)
    with open(os.path.join(out, f"{TAG}_{i}_{label}_times_err.txt"), "w") as f:
        f.write(p.stderr)
    p = subprocess.run([sys.executable, "-c", SIDE27, root], capture_output=True, text=True,
                       timeout=900, cwd=root)
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("[27")]
    print(f"{i} {label} phase 27 rc={p.returncode}: {line[0] if line else p.stderr[-1500:]}", flush=True)
    with open(os.path.join(out, f"{TAG}_{i}_{label}_27_err.txt"), "w") as f:
        f.write(p.stderr)
