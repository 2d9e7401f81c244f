"""How the process fleet starts its children (`client/children.py`): the
torch roles fork from a forkserver that imported torch once, under the
environment their parent had when it started them; validators stay
spawned and import no torch; nothing they start outlives the parent."""

import os
import signal
import subprocess
import sys

import pytest

from bflc_demo_tpu_torch.client import children


def _report(q, names):
    q.put({"env": {n: os.environ.get(n) for n in names},
           "torch_before_import": "torch" in sys.modules})


def _start(ctx, names):
    q = ctx.Queue()
    p = children.process(ctx, _report, (q, names))
    p.start()
    try:
        return q.get(timeout=120)
    finally:
        p.join(timeout=30)


def test_torch_children_fork_with_torch_loaded():
    got = _start(children.torch_context(), [])
    assert got["torch_before_import"] is True


@pytest.mark.parametrize("value", ["1", "second"])
def test_a_child_sees_its_parents_environment_of_the_moment(monkeypatch,
                                                            value):
    """The forkserver outlives a change to the parent's environment
    (it started at the first fleet); each child still sees the variables
    as the parent held them when it started that child, as a spawned
    child does, and none the parent has dropped since."""
    ctx = children.torch_context()
    monkeypatch.setenv("BFLC_CHILDREN_PROBE", "before")
    assert _start(ctx, ["BFLC_CHILDREN_PROBE"])["env"] == {
        "BFLC_CHILDREN_PROBE": "before"}
    monkeypatch.setenv("BFLC_CHILDREN_PROBE", value)
    monkeypatch.delenv("BFLC_CHILDREN_GONE", raising=False)
    got = _start(ctx, ["BFLC_CHILDREN_PROBE", "BFLC_CHILDREN_GONE"])
    assert got["env"] == {"BFLC_CHILDREN_PROBE": value,
                          "BFLC_CHILDREN_GONE": None}


def test_validator_context_is_spawned_without_torch():
    got = _start(children.spawn_context(), [])
    assert got["torch_before_import"] is False


# a parent that starts a forkserver child (and, with "stopped", SIGSTOPs
# it), prints the child's and the forkserver's pids, and exits
_PARENT = """
import multiprocessing.forkserver, os, signal, sys, time
from bflc_demo_tpu_torch.client import children
children.STOP_GRACE_S = 1.0
if __name__ == "__main__":
    p = children.process(children.torch_context(), time.sleep, (300,))
    p.start()
    if sys.argv[1] == "stopped":
        os.kill(p.pid, signal.SIGSTOP)
    print(p.pid, multiprocessing.forkserver._forkserver._forkserver_pid,
          flush=True)
"""


def _running(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            stat = f.read()
    except OSError:
        return False
    return stat[stat.rindex(")") + 2] not in "ZX"


@pytest.mark.parametrize("child", ["running", "stopped"])
def test_nothing_a_fleet_started_outlives_its_parent(tmp_path, child):
    """When the parent exits, its children (a stopped one too) and its
    forkserver have exited already: the parent stops and waits for each
    at exit, and does not hang on a child that ignores SIGTERM."""
    script = tmp_path / "parent.py"
    script.write_text(_PARENT)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # to files, not pipes: the forkserver shares the parent's standard
    # streams, and a pipe would wait for it to exit
    with open(tmp_path / "out", "w") as out, \
            open(tmp_path / "err", "w") as err:
        proc = subprocess.Popen([sys.executable, str(script), child],
                                stdout=out, stderr=err,
                                env=dict(os.environ, PYTHONPATH=repo))
    try:
        rc = proc.wait(timeout=120)
    finally:
        proc.kill()
        pids = [int(x) for x in (tmp_path / "out").read_text().split()]
        left = [pid for pid in pids if _running(pid)]
        for pid in left:
            os.kill(pid, signal.SIGKILL)
    assert rc == 0, (tmp_path / "err").read_text()[-2000:]
    assert len(pids) == 2 and pids[1] > 0, pids
    assert left == []


def _groups(q):
    q.put((os.getpid(), os.getpgid(0)))


@pytest.mark.parametrize("own_group", [False, True])
def test_a_child_the_drill_may_stop_leads_its_own_group(own_group):
    """Clients, which the writer-kill drill SIGSTOPs, lead process groups
    of their own, so no exit in the parent's group can bring SIGHUP to
    them or to the parent; other children share the parent's group."""
    ctx = children.torch_context()
    q = ctx.Queue()
    p = children.process(ctx, _groups, (q,), own_group=own_group)
    p.start()
    try:
        pid, pgid = q.get(timeout=120)
    finally:
        p.join(timeout=30)
    assert pid == p.pid
    assert pgid == (pid if own_group else os.getpgid(0))


def test_fleet_clients_start_in_their_own_groups():
    import inspect
    from bflc_demo_tpu_torch.client import process_runtime as pr
    src = inspect.getsource(pr.run_federated_processes)
    start = src.index("children.process(ctx, _client_proc")
    assert "own_group=True" in src[start:src.index("p.start()", start)]
