"""Entry points of the port: the flagship forward and a multi-device dry run
(counterparts of the TPU package's `__graft_entry__.entry` and
`dryrun_multichip`).

- `entry()` returns (forward, example_args): the flagship 3-D ResNet-18
  AD-vs-CN classifier on four full-size MNI volumes (91x109x91 at 2 mm,
  channels-last), eval mode, on the card by default;
- `dryrun_multichip(n)` runs one full data-parallel training step of a
  depth-10 ResNet over n ranks (parallel/mesh.py): the batch (2 rows a
  rank of 16x20x16) sharded over the mesh's 'data' axis, global
  BatchNorm, DDP's gradient average, Adam. With n cards each rank takes
  its own card under NCCL; with fewer it runs n gloo processes sharing the
  cards round robin (one card: all on it), and with none, or
  ``device="cpu"``, on the CPU, as the TPU package's dry run forces the
  host platform with n virtual devices. The printed line says which.

The TPU package's dry run also runs a spatially-sharded forward (the
volume's X axis over a 'space' axis, GSPMD halo exchange) and a 2-D
data x space mesh step; spatial sharding is not ported yet (ROADMAP), so
this dry run is data parallel only.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

FLAGSHIP_INPUT = (4, 91, 109, 91, 1)
DRYRUN_SHAPE = (16, 20, 16, 1)
DRYRUN_ROWS_PER_RANK = 2


def entry(device: str | torch.device = "cuda"):
    """(forward, (model, x)): ``forward(model, x)`` is the eval-mode
    ResNet-18 (shortcut B, 2 classes, the config's bf16 autocast) on
    zeros of shape (4, 91, 109, 91, 1) on `device`, giving (4, 2) logits."""
    from .core.device import resolve_device
    from .models.resnet3d import generate_model

    dev = resolve_device(device)
    model = generate_model(model_depth=18, nb_class=2,
                           generator=torch.Generator().manual_seed(0)).to(dev).eval()
    x = torch.zeros(FLAGSHIP_INPUT, device=dev)

    @torch.inference_mode()
    def forward(model, x):
        return model(x)

    return forward, (model, x)


def _placement(n: int, device: str | None) -> tuple[str, str]:
    """(backend, where) of an n-rank dry run: "nccl"/"cards" with n cards,
    "gloo"/"shared cards" with fewer, "gloo"/"cpu" without a card or when
    asked."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device == "cpu" or cards == 0:
        if device not in (None, "cpu"):
            raise RuntimeError(f"device={device!r} requested but no CUDA device is available")
        return "gloo", "cpu"
    return ("nccl", "cards") if cards >= n else ("gloo", "shared cards")


def _dryrun_rank(rank: int, n: int, store: str, backend: str, where: str, out: str):
    """One rank of `dryrun_multichip`: join the group, take one DP step."""
    import torch.distributed as dist

    from .models.resnet3d import generate_model
    from .parallel.mesh import gather_rows, init_distributed, make_mesh, shard_batch
    from .train.loop import create_train_state, make_epoch_schedule, train_step

    if where == "cpu":
        device = "cpu"
    else:
        device = f"cuda:{rank % torch.cuda.device_count()}"
    dev = init_distributed(backend=backend, device=device, init_method=f"file://{store}",
                           rank=rank, world_size=n)
    try:
        mesh = make_mesh({"data": n})
        b = DRYRUN_ROWS_PER_RANK * n
        rng = np.random.default_rng(0)
        batch = {"image": torch.from_numpy(rng.normal(size=(b, *DRYRUN_SHAPE))
                                           .astype(np.float32)),
                 "label": torch.from_numpy((np.arange(b) % 2).astype(np.int32)),
                 "mask": torch.ones(b)}
        model = generate_model(model_depth=10, nb_class=2,
                               generator=torch.Generator().manual_seed(0)).to(dev)
        state = create_train_state(model, make_epoch_schedule(1e-3, num_epochs=10), mesh=mesh)
        local = {k: v.to(dev) for k, v in shard_batch(batch, mesh).items()}
        loss, probs = train_step(state, local, torch.ones(2, device=dev))
        probs = gather_rows(probs, mesh)
        loss = float(loss)
        assert np.isfinite(loss), f"non-finite loss {loss}"
        assert tuple(probs.shape) == (b, 2), probs.shape
        if rank == 0:
            with open(out, "w") as f:
                f.write(repr(loss))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str | None = None) -> float:
    """One data-parallel train step over `n_devices` ranks (see the module
    docstring for where they run); prints one line and returns the loss.
    A rank that fails raises here."""
    import torch.multiprocessing as mp

    backend, where = _placement(n_devices, device)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "loss")
        mp.start_processes(_dryrun_rank,
                           args=(n_devices, os.path.join(tmp, "store"), backend, where, out),
                           nprocs=n_devices, join=True, start_method="spawn")
        with open(out) as f:
            loss = float(f.read())
    how = {"cards": f"{n_devices} cards (nccl)",
           "shared cards": f"{n_devices} gloo processes sharing "
                           f"{torch.cuda.device_count() if where != 'cpu' else 0} card(s)",
           "cpu": f"{n_devices} gloo processes on the CPU"}[where]
    print(f"dryrun_multichip({n_devices}): dp train step over {how} OK "
          f"(spatial sharding not ported), loss={loss:.4f}")
    return loss
