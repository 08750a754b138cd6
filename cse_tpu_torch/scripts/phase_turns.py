"""Run ``chip_smoke.py``'s [7c] and [13] from one checkout on the card; print one JSON line.

    python cse_tpu_torch/scripts/phase_turns.py CHECKOUT

[7c] is the bench recipe's fused train step (B=16, bf16; its step ms and
mixtures/s) and [13] the eval entry point (``--fused_eval`` over 256
synthetic mixtures; its mixtures/s, seconds and the card's busy share):
both read the host's speed as well as the card's. Called for two checkouts
in turns (parent, change, change, parent) in one session on one card, it
tells a change of code from a change of machine. The checkout builds its
own kernels into its own ``_build/``. The last line of standard output is
``AB {...}``. The imports sit inside ``main``: [13]'s metric workers
import this module as their ``__main__``.
"""

import sys


def main():
    import json
    import os
    import subprocess
    import time

    root = os.path.abspath(sys.argv[1])
    os.chdir(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from cse_tpu_torch.ops import _build

    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    _build.build()
    _build.library()
    built = time.time() - t0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    with torch.enable_grad():
        bench = cs.phase7_bench(torch.Generator(device="cuda").manual_seed(0), card)
    failures = []
    evals = cs.phase13(card, failures)
    e = evals["ContExt --fused_eval"]
    print("AB " + json.dumps({"checkout": sys.argv[1], "build_s": built, "7c_step_ms": bench["step_ms"],
                              "7c_mixtures_per_s": bench["mixtures_per_s"], "13b_mixtures_per_s": e["mixtures_per_s"],
                              "13b_seconds": e["seconds"], "13b_busy": e["busy_share"], "failures": failures,
                              "card": card}), flush=True)


if __name__ == "__main__":
    main()
