"""tests/torch_ranks.py's launcher on small ``-c`` children that need no
model: a rank that exits non-zero ends the group at once, a group past its
deadline is killed, both with a report that names every rank; output past the
pipe buffer cannot block a rank; and only a taken rendezvous port is retried."""

import os
import socket
import time

import pytest

from torch_ranks import RanksFailed, launch

RANK = "import os; r = int(os.environ['JAX_PROCESS_ID']); "
# both ranks rendezvous through the port's own entry and meet at a barrier
BARRIER = ("import os, torch.distributed as dist; from cse_tpu_torch.core import mesh as M; "
           "M.distributed_init_if_needed(device='cpu'); r = dist.get_rank(); ")


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def test_a_rank_that_exits_non_zero_ends_the_group(tmp_path):
    """Rank 1 exits 3 while rank 0 sleeps: the report names rank 1, its code
    and its output, and rank 0 is killed at once."""
    pid = str(tmp_path / "pid0")
    child = RANK + ("import time\nif r == 0:\n"
                    f"    open({pid!r} + '~', 'w').write(str(os.getpid())); os.replace({pid!r} + '~', {pid!r})\n"
                    "    time.sleep(300)\n"
                    f"while not os.path.exists({pid!r}): time.sleep(0.01)\n"
                    "print('one fails', flush=True); raise SystemExit(3)")
    t0 = time.monotonic()
    with pytest.raises(RanksFailed) as e:
        launch(["-c", child], 2)
    msg = str(e.value)
    assert time.monotonic() - t0 < 30
    assert "rank 1 exited 3" in msg and "--- rank 1: exited 3" in msg and "one fails" in msg
    assert "--- rank 0: killed when rank 1 exited 3" in msg and "localhost:" in msg
    assert _gone(int(open(pid).read()))


def test_a_group_past_its_deadline_is_killed_with_both_outputs():
    child = RANK + "import time; print(f'rank {r} here', flush=True); time.sleep(300 * r)"
    t0 = time.monotonic()
    with pytest.raises(RanksFailed) as e:
        launch(["-c", child], 2, timeout=6)
    msg = str(e.value)
    assert 6 <= time.monotonic() - t0 < 30
    assert "(deadline 6 s): the deadline passed" in msg
    assert "--- rank 0: exited 0" in msg and "rank 0 here" in msg
    assert "--- rank 1: killed at the deadline" in msg and "rank 1 here" in msg


def test_output_past_the_pipe_buffer_does_not_block_a_rank():
    """Rank 1 writes 1 MiB before a gloo barrier with rank 0: a launcher that
    drained rank 0 first would leave rank 1 blocked on a full pipe and rank 0
    waiting at the barrier."""
    child = BARRIER + "print('x' * (1 << 20) if r else 'short', flush=True); dist.barrier(); print('after', r)"
    outs = launch(["-c", child], 2)
    assert len(outs[1]) > 1 << 20 and "short" in outs[0].splitlines()
    assert all(out.rstrip().endswith(f"after {r}") for r, out in enumerate(outs))


def test_a_taken_port_is_retried_once_and_nothing_else_is(tmp_path):
    with socket.socket() as held:
        held.bind(("localhost", 0))
        held.listen()
        port = held.getsockname()[1]
        outs = launch(["-c", BARRIER + "dist.barrier(); print('ADDR', os.environ['COORDINATOR_ADDRESS'])"], 2,
                      port=port)
        addrs = {out.split("ADDR ")[1].split()[0] for out in outs}
        assert len(addrs) == 1 and addrs != {f"localhost:{port}"}

    # rank 0 fails for another reason: one start; it says that its port is
    # taken every time: two starts, and the report says so
    starts = tmp_path / "starts"
    for said, n_starts in (("no luck", 1), ("EADDRINUSE", 2)):
        child = RANK + ("import time\nif r == 0:\n"
                        f"    open({str(starts)!r}, 'a').write('start\\n'); raise SystemExit({said!r})\n"
                        "time.sleep(300)")
        with pytest.raises(RanksFailed, match="rank 0 exited 1") as e:
            launch(["-c", child], 2)
        assert starts.read_text().count("start") == n_starts and said in str(e.value)
        assert ("a second start" in str(e.value)) == (n_starts == 2)
        starts.unlink()
