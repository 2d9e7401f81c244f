"""How the process fleet starts its children.

Every role that imports torch (the writer, the clients, the standbys,
the replicas) forks from a `multiprocessing` forkserver that imported
torch once (`torch_context`): a child then skips the import, which takes
seconds of CPU in every process and, with 20 clients booting at once on
a few cores, most of a fleet's start (a config-5 fleet on an H100:
36-49 s spawned, 7-10 s forked).  The forkserver is a fresh interpreter
that never touches CUDA, so a child initialises its own device as a
spawned one does; its only threads are the BLAS pools numpy and torch
start at import, which re-create themselves in a forked child.  BFT
validators are ledger and crypto only and import no torch; they stay
spawned (`spawn_context`).

A forkserver's child inherits the server's environment, not its
parent's: `process` sends the parent's `os.environ` along and installs
it before the role's module is imported, so each child sees the
environment of the moment it was started, as a spawned one does (the
fleet's `BFLC_*` switches are read at import and at call time).  Only
numpy arrays, bytes and plain values cross, as with spawn.

The forkserver lives on between fleets and would outlive its parent by
the seconds its torch takes to shut down (longer while a forked child
still runs): `stop_children` stops the children still running, then
the forkserver and the resource tracker, and waits for each; it runs at exit once a forkserver
context was made, so nothing a fleet started outlives the process that
started it.
"""

from __future__ import annotations

import atexit
import importlib
import multiprocessing as mp
import multiprocessing.forkserver
import os
import sys
import time
from typing import Callable, Optional, Sequence

# what the forkserver imports once for every child it forks
PRELOAD = ["torch"]
# seconds a child has between SIGTERM and SIGKILL in `stop_children`
STOP_GRACE_S = 10.0

_stop_at_exit = False


def torch_context():
    """The context for roles that import torch: a forkserver that
    preloaded `PRELOAD`, stopped at exit (`stop_children`)."""
    global _stop_at_exit
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(PRELOAD)
    if not _stop_at_exit:
        # runs before multiprocessing's own exit handler, which would
        # join a child that ignores SIGTERM (a stopped one) for ever
        atexit.register(stop_children)
        _stop_at_exit = True
    return ctx


def stop_children(grace_s: Optional[float] = None) -> None:
    """Stop every daemonic child of this process that still runs
    (SIGTERM, then SIGKILL `grace_s` later, `STOP_GRACE_S` by default;
    SIGKILL also ends a stopped one) and join it, then stop this process's forkserver and resource
    tracker, if it started them, and wait for each to exit.  The
    forkserver exits once every child it forked has closed its end of
    the server's pipe, so the children go first."""
    live = [p for p in mp.active_children() if p.daemon]
    for p in live:
        p.terminate()
    deadline = time.monotonic() + (STOP_GRACE_S if grace_s is None
                                   else grace_s)
    for p in live:
        p.join(max(0.0, deadline - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join()
    # the standard library's own stops (its tests use them): close the
    # server's pipe, then waitpid; the resource tracker (started by the
    # first child) goes the same way, and either restarts on next use
    multiprocessing.forkserver._forkserver._stop()
    tracker = sys.modules.get("multiprocessing.resource_tracker")
    if tracker is not None:
        tracker._resource_tracker._stop()


def spawn_context():
    """The context for roles that must not import torch (validators)."""
    return mp.get_context("spawn")


def _run(environ: dict, module: str, name: str, args: tuple,
         own_group: bool = False) -> None:
    if own_group:
        os.setpgid(0, 0)
    os.environ.clear()
    os.environ.update(environ)
    getattr(importlib.import_module(module), name)(*args)


def process(ctx, target: Callable, args: Sequence = (),
            daemon: bool = True, own_group: bool = False):
    """`ctx.Process` running `target(*args)` under this process's
    current environment; `target` is imported by name in the child,
    after the environment is in place.

    own_group: the child leads a process group of its own.  A child the
    parent may SIGSTOP needs one.  While a stopped process sits in an
    orphaned group (the parent's, when the parent leads a session of
    its own), the exit of another member (a killed writer) can bring
    SIGHUP to the whole group, the parent included: Linux sends it when
    that exit orphans the group, gVisor on any exit in it.  A group of
    its own, whose parent (the forkserver) is in another group of the
    same session, is never orphaned."""
    return ctx.Process(target=_run, args=(
        dict(os.environ), target.__module__, target.__qualname__,
        tuple(args), own_group), daemon=daemon)
