"""Entry points of the port: the flagship forward and a multi-device dry run
(counterparts of the TPU package's `__graft_entry__.entry` and
`dryrun_multichip`).

- `entry()` returns (forward, example_args): the flagship 3-D ResNet-18
  AD-vs-CN classifier on four full-size MNI volumes (91x109x91 at 2 mm,
  channels-last), eval mode, on the card by default;
- `dryrun_multichip(n)` runs, over n ranks (parallel/mesh.py), what the
  TPU package's dry run runs: one full data-parallel training step of a
  depth-10 ResNet (the batch, 2 rows a rank of 16x20x16, sharded over the
  mesh's 'data' axis, global BatchNorm, DDP's gradient average, Adam);
  the n-way spatially-sharded forward of its weights at (2, 16, 20, 16, 1)
  (the volume's X over a 'space' axis, halo exchanges; parallel/spatial.py)
  with ``s2d_stem`` True and False; and at n >= 4 and even one train step
  on the 2-D ``{"data": n/2, "space": 2}`` mesh, the ResNet spatially
  sharded. Rank 0 holds the spatial forward and the 2-D step (both fp32)
  against the unsharded forward and the one-process step. With n cards
  each rank takes its own card under NCCL; with fewer it runs n gloo
  processes sharing the cards round robin (one card: all on it), and with
  none, or ``device="cpu"``, on the CPU, as the TPU package's dry run
  forces the host platform with n virtual devices. The printed line says
  which, and names the parts.
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


#: rank 0's bound on the spatially sharded fp32 forward and 2-D step against
#: the unsharded ones, as a share of the logits' spread and of the loss
#: (cuDNN takes other algorithms on slabs: ~1e-6 apart, not bit-equal)
DRYRUN_SPATIAL_BOUND = 1e-4


def _dryrun_rank(rank: int, n: int, store: str, backend: str, where: str, out: str):
    """One rank of `dryrun_multichip`: join the group, take one DP step, the
    spatially sharded forward, the 2-D step."""
    import torch.distributed as dist

    from .models.resnet3d import generate_model
    from .parallel.mesh import (gather_rows, init_distributed, make_mesh, shard_batch,
                                spatial_sharding)
    from .parallel.spatial import convert_spatial
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
        result = {"loss": loss}
        sd = {k: v.detach().clone() for k, v in state.model.state_dict().items()}

        def fp32_model(s2d=True):
            m = generate_model(model_depth=10, nb_class=2, compute_dtype=torch.float32,
                               dropout_rate=0.0, s2d_stem=s2d).to(dev)
            m.load_state_dict(sd)
            return m

        # n-way spatial forward, both stems, against the unsharded one
        mesh_sp = make_mesh({"space": n})
        x = batch["image"][:2].to(dev)
        with torch.no_grad():
            ref = fp32_model().eval()(x) if rank == 0 else None
        err = 0.0
        for s2d in (True, False):
            m = convert_spatial(fp32_model(s2d).eval(), mesh_sp)
            with torch.no_grad():
                logits = m(spatial_sharding(mesh_sp).slab(x))
            assert bool(torch.isfinite(logits).all()), f"s2d_stem={s2d}"
            if rank == 0:
                spread = float(ref.max() - ref.min())
                err = max(err, float((logits - ref).abs().max()) / spread)
        assert err <= DRYRUN_SPATIAL_BOUND, f"spatial forward {err:.3g} of the spread"
        result["spatial_err"] = err

        # dp x sp on one 2-D mesh, against one process on the global batch
        if n >= 4 and n % 2 == 0:
            mesh2 = make_mesh({"data": n // 2, "space": 2})
            cw = torch.ones(2, device=dev)
            st2 = create_train_state(fp32_model(), make_epoch_schedule(1e-3, num_epochs=10),
                                     mesh=mesh2, spatial=True)
            local2 = {k: v.to(dev) for k, v in shard_batch(batch, mesh2, spatial=1).items()}
            loss2 = float(train_step(st2, local2, cw)[0])
            assert np.isfinite(loss2), f"non-finite 2-D mesh loss {loss2}"
            if rank == 0:
                one = create_train_state(fp32_model(), make_epoch_schedule(1e-3, num_epochs=10))
                ref2 = float(train_step(one, {k: v.to(dev) for k, v in batch.items()}, cw)[0])
                rel = abs(loss2 - ref2) / abs(ref2)
                assert rel <= DRYRUN_SPATIAL_BOUND, f"2-D step loss {loss2} vs {ref2}"
                result.update(loss_2d=loss2, loss_2d_rel=rel)
        if rank == 0:
            with open(out, "w") as f:
                f.write(repr(result))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str | None = None) -> float:
    """The dry run over `n_devices` ranks (see the module docstring for what
    runs and where); prints one line and returns the data-parallel step's
    loss. A rank that fails, or a check that misses its bound, raises
    here."""
    import ast

    import torch.multiprocessing as mp

    backend, where = _placement(n_devices, device)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result")
        mp.start_processes(_dryrun_rank,
                           args=(n_devices, os.path.join(tmp, "store"), backend, where, out),
                           nprocs=n_devices, join=True, start_method="spawn")
        with open(out) as f:
            result = ast.literal_eval(f.read())
    how = {"cards": f"{n_devices} cards (nccl)",
           "shared cards": f"{n_devices} gloo processes sharing "
                           f"{torch.cuda.device_count() if where != 'cpu' else 0} card(s)",
           "cpu": f"{n_devices} gloo processes on the CPU"}[where]
    extra = ""
    if "loss_2d" in result:
        extra = (f" + 2-D {{'data': {n_devices // 2}, 'space': 2}} dp x sp train step "
                 f"(loss={result['loss_2d']:.4f}, {result['loss_2d_rel']:.2g} from one "
                 "process)")
    print(f"dryrun_multichip({n_devices}): dp train step over {how} OK + {n_devices}-way "
          f"spatially-sharded forward (s2d + naive stems, {result['spatial_err']:.2g} of the "
          f"logits' spread from the unsharded forward){extra}, loss={result['loss']:.4f}")
    return result["loss"]
