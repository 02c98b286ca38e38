"""Support shared by the port's test files: `cap_torch_threads`, which each
of them calls at import, and the `default_torch_threads` fixture.

pytest-xdist runs several workers on the box's cores, and torch's intra-op
pool defaults to one thread a core in every worker. Six workers then run
six pools of all the cores: the pools' threads wait on each other at every
parallel region of the small ops these tests run, and a test that takes
seconds alone takes minutes (the ICL estimators' meta-training test: 5 s
alone, 316 s in the suite). Each worker keeps its share of the cores.

The thread count also sets how torch's CPU reductions split their sums. A
few tests hold float32 statistics of large tensors (BatchNorm moments,
three train steps) to the JAX package's at a bound met with torch's
default split, not with one thread's sequential sums; they take
`default_torch_threads`, which restores the default for their duration.

`run_ranks` runs a function in W processes joined in one gloo process
group (the data-parallel tests): each rank is a `torch.multiprocessing`
spawn that rendezvouses through a ``file://`` store under the test's
temporary directory (no ports), caps its threads, and saves what the
function returns; a rank that raises or outlives the time limit fails the
test, and the others are killed with it."""

import contextlib
import importlib
import os
import shutil
import time

import pytest
import torch

#: torch's intra-op threads before any cap (the module is imported first)
DEFAULT_THREADS = torch.get_num_threads()


def worker_count() -> int:
    """The xdist workers of this run (1 outside xdist)."""
    return max(1, int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


def thread_cap(cpus: int | None = None, workers: int | None = None) -> int:
    """``max(1, cpus // workers)``: this worker's share of the cores."""
    cpus = cpus if cpus is not None else len(os.sched_getaffinity(0))
    workers = workers if workers is not None else worker_count()
    return max(1, cpus // workers)


def cap_torch_threads() -> int:
    """Lower torch's intra-op threads to this worker's share of the cores
    (never raise them); returns the count in force."""
    cap = thread_cap()
    if torch.get_num_threads() > cap:
        torch.set_num_threads(cap)
    return torch.get_num_threads()


@contextlib.contextmanager
def torch_threads(n: int):
    """`n` intra-op threads inside the block."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def default_threads():
    """torch's default intra-op thread count inside the block."""
    return torch_threads(DEFAULT_THREADS)


@pytest.fixture
def default_torch_threads():
    with default_threads():
        yield


def _rank_main(rank, world, store, module, name, args, out_dir, threads):
    """One rank of `run_ranks`: join the group, run module.name(*args),
    save its result."""
    import torch.distributed as dist

    torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        result = getattr(importlib.import_module(module), name)(*args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 240.0,
              threads: int | None = None) -> list:
    """[fn(*args) of rank 0, ..., of rank world - 1], each rank a spawned
    process in one gloo group over a file:// store under `tmp_path`. `fn` is
    a module-level function; a rank that fails, or a run longer than
    `timeout` seconds, raises (every rank is stopped). Each rank runs
    `threads` intra-op threads, by default its share of this worker's."""
    import torch.multiprocessing as mp

    out = tmp_path / f"ranks-{fn.__name__}-{time.monotonic_ns()}"
    out.mkdir()
    if threads is None:
        threads = max(1, thread_cap() // world)
    ctx = mp.start_processes(
        _rank_main, args=(world, str(out / "store"), fn.__module__, fn.__name__, args,
                          str(out), threads),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} on {world} ranks ran past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    results = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]
    shutil.rmtree(out)  # results hold whole models: keep the disk free
    return results


@pytest.mark.parametrize("cpus,workers,cap",
                         [(8, 6, 1), (8, 1, 8), (8, 2, 4), (2, 6, 1), (1, 1, 1)])
def test_thread_cap(cpus, workers, cap):
    assert thread_cap(cpus, workers) == cap


def test_cap_torch_threads_never_raises_the_count():
    before = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        assert cap_torch_threads() == 1
    finally:
        torch.set_num_threads(before)
    assert cap_torch_threads() == min(before, thread_cap())
    with default_threads():
        assert torch.get_num_threads() == DEFAULT_THREADS
    assert torch.get_num_threads() == min(before, thread_cap())
