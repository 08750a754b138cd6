"""Count four-rank gloo groups in which a rank does not exit 0, with and
without ``cse_tpu_torch/core/mesh.py``'s exit hook (``_destroy_at_exit``,
which destroys the process group before the interpreter tears down).

    python tests/rank_teardown.py --groups 120 [--loops 4]

Each loop starts ``--groups`` groups one after another through
tests/torch_ranks.py, alternating the hook off and on; ``--loops`` such loops
run side by side. Every rank builds tests/test_torch_llama_tp.py's two meshes
(1 x 4 and 2 x 2), all-reduces over each of their groups and the world, and
exits. Prints one line per failed group and the counts by setting.
"""

import argparse
import collections
import threading
import time

from torch_ranks import RanksFailed, launch

CHILD = r"""
import atexit, sys, torch, torch.distributed as dist
torch.set_num_threads(1)
from cse_tpu_torch.core import mesh as M
M.distributed_init_if_needed(device="cpu")
if sys.argv[1] == "off":
    atexit.unregister(M._destroy_at_exit)
x = torch.ones(8)
for m in (M.make_mesh(1, 4, device="cpu"), M.make_mesh(2, 2, device="cpu")):
    for g in (m.data_group, m.model_group):
        if g is not None:
            dist.all_reduce(x, group=g)
dist.all_reduce(x)
print("DONE", float(x[0]), flush=True)
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", type=int, default=120, help="groups a loop, alternating the hook off and on")
    ap.add_argument("--loops", type=int, default=1, help="loops side by side")
    args = ap.parse_args()
    runs, failed, lock = collections.Counter(), collections.Counter(), threading.Lock()

    def loop():
        for i in range(args.groups):
            hook = ("off", "on")[i % 2]
            try:
                launch(["-c", CHILD, hook], 4)
                bad = None
            except RanksFailed as e:
                bad = str(e).splitlines()[0].rsplit(": ", 1)[-1]
            with lock:
                runs[hook] += 1
                if bad:
                    failed[hook] += 1
                    print(f"hook {hook}: {bad}", flush=True)

    t0 = time.monotonic()
    threads = [threading.Thread(target=loop) for _ in range(args.loops)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for hook in ("off", "on"):
        print(f"hook {hook}: {failed[hook]} of {runs[hook]} groups failed")
    print(f"{args.loops} loop(s) of {args.groups} groups in {time.monotonic() - t0:.1f} s")


if __name__ == "__main__":
    main()
