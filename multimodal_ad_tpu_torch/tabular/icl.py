"""In-context tabular learner (TabPFN-style prior-fitted transformer), in
PyTorch (own copy of the TPU package's tabular/icl.py):

- a row-token transformer: each table row is one token (feature values
  z-scored by context statistics, projected to d_model); context rows add a
  label embedding, query rows a learned [QUERY] embedding; an optional
  categorical pathway adds two projections driven by a per-feature
  categorical indicator;
- masked attention: every token attends to the valid context tokens and
  to itself; queries are never keys for other tokens. Padded context rows
  still run through the trunk, and their keys are masked;
- `ICLClassifier.fit` stores the preprocessed, padded context and its
  permuted views on the device; `predict_proba` / `get_embeddings` run one
  batched forward over the views. No gradient at inference;
- meta-training (`pretrain_icl`) on synthetic tasks from the random-function
  prior: `sample_tasks` on the host (the TPU package's numpy draws, array
  for array) or `icl_prior.sample_tasks_device` on the card.

The network follows flax's defaults, not torch's: LayerNorm epsilon 1e-6,
the tanh approximation of GELU, the query scaled by 1/sqrt(head_dim) before
the product, masked scores set to float32's minimum (not -inf), all in
float32 (TF32 off, core/device.py). The attention is the explicit scaled
product, mask and softmax.

Weights: the bundled meta-trained assets (`assets/*.msgpack`, flax
state, read by `flax_msgpack.py` and converted by
`utils/torch_weights.py::icl_state_dict_from_flax`) under the same policy
as the TPU package (`resolve_asset_params`). Where no asset applies and no
`params` are given, the estimators meta-train a network on their device,
as the TPU package does, and keep it in the process-wide cache.

The host preprocessing (imputation, width screen, whiten / quantile /
onehot / pairs, context buckets) is the TPU package's numpy code, with
`estimator.py` in place of sklearn.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from .estimator import BaseEstimator, ClassifierMixin

#: flax's LayerNorm epsilon
LN_EPS = 1e-6

#: how many networks built from caller-given weight trees stay on a device
_EXPLICIT_NETWORKS = 4


@dataclass(frozen=True)
class ICLConfig:
    """The bundled asset's capacity: d_model 256, 6 layers, 192 features,
    10 classes, 512 context rows, the categorical pathway on."""

    d_model: int = 256
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 1024
    max_features: int = 192
    max_classes: int = 10
    max_context: int = 512
    dropout: float = 0.0
    cat_input: bool = True


class ICLAttention(nn.Module):
    """flax's MultiHeadDotProductAttention over (B, T, D) with a (B, T, T)
    boolean mask of allowed keys, as the explicit scaled product."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def heads(self, y):
        """(q, k, v) as (B, H, T, head_dim), the query already scaled."""
        b, t, d = y.shape
        hd = d // self.n_heads
        split = lambda z: z.view(b, t, self.n_heads, hd).transpose(1, 2)  # noqa: E731
        return (split(self.query(y)) / math.sqrt(hd), split(self.key(y)),
                split(self.value(y)))

    def forward(self, y, allowed):
        q, k, v = self.heads(y)
        out = masked_attention(q, k, v, allowed)
        b, _, t, _ = out.shape
        return self.out(out.transpose(1, 2).reshape(b, t, -1))


def masked_attention(q, k, v, allowed):
    """softmax(where(allowed, q k^T, float32 min)) v over (B, H, T, hd)
    heads; `q` is already scaled."""
    w = q @ k.transpose(-1, -2)
    w = torch.where(allowed[:, None], w, torch.finfo(w.dtype).min)
    return torch.softmax(w, dim=-1) @ v


class ICLBlock(nn.Module):
    """Pre-LayerNorm attention + GELU MLP block (the flax ICLBlock)."""

    def __init__(self, cfg):
        super().__init__()
        d = cfg.d_model
        self.ln1 = nn.LayerNorm(d, eps=LN_EPS)
        self.attn = ICLAttention(d, cfg.n_heads)
        self.ln2 = nn.LayerNorm(d, eps=LN_EPS)
        self.fc1 = nn.Linear(d, cfg.d_ff)
        self.fc2 = nn.Linear(cfg.d_ff, d)

    def forward(self, h, allowed):
        h = h + self.attn(self.ln1(h), allowed)
        return h + self.fc2(F.gelu(self.fc1(self.ln2(h)), approximate="tanh"))


def attention_mask(ctx_mask, m: int):
    """(B, N+M, N+M) boolean: every token may attend to the valid context
    tokens and to itself."""
    b, n = ctx_mask.shape
    key_is_ctx = torch.cat([ctx_mask.bool(),
                            torch.zeros((b, m), dtype=torch.bool, device=ctx_mask.device)], 1)
    eye = torch.eye(n + m, dtype=torch.bool, device=ctx_mask.device)
    return key_is_ctx[:, None, :] | eye[None]


class ICLTrunk(nn.Module):
    """The blocks and the final LayerNorm, shared with the regression net."""

    def __init__(self, cfg):
        super().__init__()
        self.blocks = nn.ModuleList(ICLBlock(cfg) for _ in range(cfg.n_layers))
        self.norm = nn.LayerNorm(cfg.d_model, eps=LN_EPS)

    def run(self, h, ctx_mask, n: int, return_penult: bool):
        """(final normalized h, the penultimate layer's query states or
        None)."""
        allowed = attention_mask(ctx_mask, h.shape[1] - n)
        penult = None
        for li, block in enumerate(self.blocks):
            h = block(h, allowed)
            if return_penult and li == len(self.blocks) - 2:
                penult = h[:, n:]
        return self.norm(h), penult


class ICLTransformer(ICLTrunk):
    """Forward over a batch of in-context classification tasks.

    Inputs: x_ctx (B, N, F), y_ctx (B, N) int, ctx_mask (B, N) {0,1},
    x_qry (B, M, F), cat_mask (B, F) or None.
    Returns logits (B, M, max_classes), qry_emb (B, M, d_model), ctx_emb
    (B, N, d_model), and with ``return_penult`` the penultimate layer's
    query states (B, M, d_model).
    """

    def __init__(self, cfg: ICLConfig):
        super().__init__(cfg)
        self.cfg = cfg
        d, f = cfg.d_model, cfg.max_features
        self.feature_proj = nn.Linear(f, d)
        self.label_embed = nn.Embedding(cfg.max_classes, d)
        self.query_token = nn.Parameter(torch.randn(d) * 0.02)
        if cfg.cat_input:
            self.cat_proj = nn.Linear(f, d)
            self.cat_ind = nn.Linear(f, d, bias=False)
            for p in (self.cat_proj.weight, self.cat_proj.bias, self.cat_ind.weight):
                nn.init.zeros_(p)  # flax zero-initializes both
        self.cls_head = nn.Linear(d, cfg.max_classes)

    def forward(self, x_ctx, y_ctx, ctx_mask, x_qry, cat_mask=None, return_penult=False):
        b, n, f = x_ctx.shape
        h_ctx = self.feature_proj(x_ctx) + self.label_embed(y_ctx.long())
        h_qry = self.feature_proj(x_qry) + self.query_token
        if self.cfg.cat_input:
            if cat_mask is None:
                cat_mask = x_ctx.new_zeros((b, f))
            ind = self.cat_ind(cat_mask)[:, None, :]
            cm = cat_mask[:, None, :]
            h_ctx = h_ctx + self.cat_proj(x_ctx * cm) + ind
            h_qry = h_qry + self.cat_proj(x_qry * cm) + ind
        h, penult = self.run(torch.cat([h_ctx, h_qry], 1), ctx_mask, n, return_penult)
        out = (self.cls_head(h[:, n:]), h[:, n:], h[:, :n])
        return out + (penult,) if return_penult else out


def _zscore_by_ctx(x_ctx, x_qry, ctx_mask):
    """z-score context and query features by the valid context rows'
    statistics; padded context rows come out 0."""
    m = ctx_mask[..., None]
    denom = torch.clamp(ctx_mask.sum(1, keepdim=True), min=1.0)[..., None]
    mean = (x_ctx * m).sum(1, keepdim=True) / denom
    var = (((x_ctx - mean) ** 2) * m).sum(1, keepdim=True) / denom
    std = torch.sqrt(var + 1e-6)
    return (x_ctx - mean) / std * m, (x_qry - mean) / std


# ----------------------------------------------------------------------
# the synthetic-task prior of meta-training (host numpy)
# ----------------------------------------------------------------------

def _rand_cut_labels(rng: np.random.Generator, score, c: int):
    """Bucket `score` at RANDOM cut quantiles (sorted uniforms in
    [0.05, 0.95]): every bucketed task family carries random class
    imbalance."""
    u = np.sort(rng.uniform(0.05, 0.95, c - 1))
    return np.digitize(score, np.quantile(score, u))


#: default family mixture weights (cluster, correlated-latent,
#: pairwise-interaction, periodic, shallow-MLP); cumulative thresholds
#: 0.22/0.40/0.62/0.74 — shared by the host sampler and the device prior.
DEFAULT_FAMILY_MIX = (0.22, 0.18, 0.22, 0.12, 0.26)


def _mix_thresholds(mix):
    """Normalize 5 family weights to the 4 cumulative cut points used by
    the samplers' `kind` draw."""
    w = np.asarray(mix, np.float64)
    if w.shape != (5,) or (w < 0).any() or w.sum() <= 0:
        raise ValueError("mix must be 5 non-negative family weights")
    cum = np.cumsum(w / w.sum())
    return tuple(float(t) for t in cum[:4])


def sample_tasks(rng: np.random.Generator, batch: int, cfg: ICLConfig,
                 n_ctx: int, n_qry: int, var_ctx: bool = True,
                 mix=None):
    """Random-function prior: gaussian/mixed/correlated features ->
    random score (cluster, latent-linear, pairwise-interaction, periodic,
    or shallow MLP) -> quantile-bucketed labels (+ label noise). The TPU
    package's sampler, draw for draw: the same `rng` gives the same arrays.

    With ``var_ctx`` each task draws a random VALID context length in
    [16, n_ctx] (the tail is zeroed and masked out). ``mix`` overrides the
    five family weights (``DEFAULT_FAMILY_MIX``)."""
    F, C = cfg.max_features, cfg.max_classes
    t1, t2, t3, t4 = _mix_thresholds(DEFAULT_FAMILY_MIX if mix is None
                                     else mix)
    n = n_ctx + n_qry
    x = np.zeros((batch, n, F), np.float32)
    y = np.zeros((batch, n), np.int64)
    cat = np.zeros((batch, F), np.float32)  # per-task categorical columns
    for b in range(batch):
        f = int(rng.integers(3, max(4, F // 2) + 1))
        # class count skewed toward binary, still covering the alphabet
        c = 2 if (C > 2 and rng.random() < 0.5) else int(rng.integers(2, C + 1))
        kind = rng.random()
        if kind < t1:
            # cluster prior: class-conditional gaussians with random
            # separation, Dirichlet class frequencies, a few columns
            # quantized to integer codes
            sep = rng.uniform(0.5, 3.0)
            centers = rng.normal(size=(c, f)).astype(np.float32) * sep
            probs = rng.dirichlet(np.full(c, rng.uniform(0.4, 3.0)))
            probs = 0.9 * probs + 0.1 / c  # keep every class reachable
            lab = rng.choice(c, size=n, p=probs)
            xs = centers[lab] + rng.normal(size=(n, f)).astype(np.float32)
            n_cat = int(rng.integers(0, max(1, f // 3) + 1))
            for jcol in rng.choice(f, n_cat, replace=False):
                xs[:, jcol] = np.digitize(xs[:, jcol],
                                          [-0.5, 0.5]).astype(np.float32)
                cat[b, jcol] = 1.0
        elif kind < t2:
            # correlated-latent prior: features are linear mixes of fewer
            # latents plus small noise; half the tasks score on the
            # latents, half on a direction drawn in whitened coordinates
            k = int(rng.integers(1, max(2, f // 2) + 1))
            z = rng.normal(size=(n, k)).astype(np.float32)
            mix = rng.normal(size=(k, f)).astype(np.float32)
            eps = rng.uniform(0.02, 0.3)
            xs = z @ mix + eps * rng.normal(size=(n, f)).astype(np.float32)
            if rng.random() < 0.5:
                score = z @ rng.normal(size=k).astype(np.float32)
            else:
                cov = np.cov(xs, rowvar=False) + 1e-6 * np.eye(f)
                evals, evecs = np.linalg.eigh(cov)
                w = evecs @ (rng.normal(size=f) / np.sqrt(evals))
                score = (xs - xs.mean(0)) @ w.astype(np.float32)
            lab = _rand_cut_labels(rng, score, c)
        elif kind < t3:
            # pairwise-interaction prior: products of feature pairs; half
            # the tasks use SIGN products (no magnitude cue)
            xs = rng.normal(size=(n, f)).astype(np.float32)
            n_pairs = int(rng.integers(1, 4))
            hard = rng.random() < 0.5
            score = ((0.0 if hard else 0.2)
                     * xs @ rng.normal(size=f).astype(np.float32))
            for _ in range(n_pairs):
                i, j = rng.choice(f, 2, replace=False)
                term = xs[:, i] * xs[:, j]
                if hard:
                    term = np.sign(term)
                score = score + rng.normal() * term
            lab = _rand_cut_labels(rng, score, c)
        elif kind < t4:
            # periodic prior: sinusoids of single features
            xs = rng.normal(size=(n, f)).astype(np.float32)
            n_waves = int(rng.integers(1, 3))
            score = 0.1 * xs @ rng.normal(size=f).astype(np.float32)
            for _ in range(n_waves):
                i = int(rng.integers(0, f))
                w = rng.uniform(1.0, 4.0)
                ph = rng.uniform(0, 2 * np.pi)
                score = score + rng.normal() * np.sin(w * xs[:, i] + ph)
            lab = _rand_cut_labels(rng, score, c)
        else:
            # function prior: random shallow MLP score, quantile-bucketed
            xs = rng.normal(size=(n, f)).astype(np.float32)
            n_cat = int(rng.integers(0, max(1, f // 3) + 1))
            for j in rng.choice(f, n_cat, replace=False):
                xs[:, j] = np.digitize(xs[:, j], [-0.5, 0.5]).astype(np.float32)
                cat[b, j] = 1.0
            h1 = np.tanh(xs @ rng.normal(size=(f, 8)).astype(np.float32)
                         + rng.normal(size=8).astype(np.float32))
            score = (h1 @ rng.normal(size=8).astype(np.float32)
                     + 0.3 * xs @ rng.normal(size=f).astype(np.float32))
            lab = _rand_cut_labels(rng, score, c)
        # label-noise rate drawn per task, mostly near zero
        flip_rate = (rng.uniform(0.0, 0.02) if rng.random() < 0.6
                     else rng.uniform(0.02, 0.12))
        flip = rng.random(lab.shape) < flip_rate
        lab = np.where(flip, rng.integers(0, c, n), lab)
        x[b, :, :f] = xs
        y[b] = lab
    ctx_mask = np.ones((batch, n_ctx), np.float32)
    if var_ctx and n_ctx > 16:
        for b in range(batch):
            n_valid = int(rng.integers(16, n_ctx + 1))
            ctx_mask[b, n_valid:] = 0.0
            x[b, n_valid:n_ctx] = 0.0
            y[b, n_valid:n_ctx] = 0
    return {
        "x_ctx": x[:, :n_ctx], "y_ctx": y[:, :n_ctx].astype(np.int32),
        "ctx_mask": ctx_mask,
        "x_qry": x[:, n_ctx:], "y_qry": y[:, n_ctx:].astype(np.int32),
        "cat_mask": cat,
    }


# ----------------------------------------------------------------------
# meta-training
# ----------------------------------------------------------------------

def init_icl_params(cfg: ICLConfig, seed: int = 0) -> dict:
    """Fresh classifier weights in flax's layout, drawn from flax's
    initializers (`meta_train.flax_init_tree`); the categorical
    projections start at zero, as in the TPU package."""
    from ..utils.torch_weights import icl_name_map
    from .meta_train import flax_init_tree

    return flax_init_tree(icl_name_map(cfg), seed, zero=("cat_proj", "cat_ind"))


def icl_meta_loss(net: ICLTransformer, task: dict, aux_embed: float = 0.0,
                  aux_tau: float = 0.2, aux_qc: float = 0.0):
    """The meta-training loss of one task batch: the queries' NLL, plus
    ``aux_embed`` x the supervised-contrastive loss among each task's
    query states (same class attracts, the query itself excluded) and
    ``aux_qc`` x the query -> valid-context contrastive loss, both at
    temperature ``aux_tau``."""
    from .meta_train import supervised_contrastive, unit_rows

    mask = task["ctx_mask"]
    xc, xq = _zscore_by_ctx(task["x_ctx"], task["x_qry"], mask)
    logits, q_emb, c_emb = net(xc, task["y_ctx"], mask, xq, task.get("cat_mask"))
    yq = task["y_qry"].long()
    loss = -F.log_softmax(logits, -1).gather(-1, yq[..., None]).mean()
    if aux_embed > 0.0:
        z = unit_rows(q_emb)
        sim = z @ z.transpose(1, 2) / aux_tau
        others = ~torch.eye(sim.shape[1], dtype=torch.bool, device=sim.device)[None]
        same = (yq[:, :, None] == yq[:, None, :]) & others
        loss = loss + aux_embed * supervised_contrastive(sim, others.expand_as(same), same)
    if aux_qc > 0.0:
        valid = (mask > 0)[:, None, :]
        sim = unit_rows(q_emb) @ unit_rows(c_emb).transpose(1, 2) / aux_tau
        same = (yq[:, :, None] == task["y_ctx"].long()[:, None, :]) & valid
        loss = loss + aux_qc * supervised_contrastive(sim, valid.expand_as(same), same)
    return loss


def pretrain_icl(cfg: ICLConfig = ICLConfig(), steps: int = 3000,
                 batch: int = 32, n_ctx: int = 96, n_qry: int = 32,
                 lr: float = 3e-4, seed: int = 0, verbose: bool = False,
                 init_params=None, device_prior: bool = False,
                 chunk: int = 100, mix=None, aux_embed: float = 0.0,
                 aux_tau: float = 0.2, aux_qc: float = 0.0,
                 device: str | torch.device = "cuda"):
    """Meta-train the prior-fitted network on synthetic tasks on `device`;
    returns (params, cfg), params the flax-layout tree ({'params': ...} of
    float32 numpy arrays) that `ICLClassifier(params=...)` and the TPU
    package take.

    ``init_params`` warm-starts from such a tree (fresh optimizer state);
    otherwise the weights are `init_icl_params(cfg, seed)`. The optimizer
    is the TPU package's (`meta_train.MetaTrainer`). The loss is
    `icl_meta_loss` with ``aux_embed`` / ``aux_tau`` / ``aux_qc``.

    Host prior (default): one `sample_tasks` draw a step from
    ``np.random.default_rng(seed)``, uploaded; the stream equals the TPU
    package's (its first draw, which there builds the initial weights, is
    drawn here too). ``device_prior``: tasks from
    `icl_prior.sample_tasks_device` on the device, from a generator seeded
    `seed`, ``chunk`` steps at a time with the losses read once a chunk;
    the last chunk is cut to the remainder. ``mix`` overrides the prior's
    family weights in both.

    The network is built and trained here, outside any inference mode;
    only the trained tree leaves."""
    from ..utils.torch_weights import icl_flax_from_state_dict, icl_state_dict_from_flax
    from .meta_train import MetaTrainer, run_device_chunks

    dev = resolve_device(device)
    mix_t = None if mix is None else tuple(float(w) for w in mix)
    rng = np.random.default_rng(seed)
    sample_tasks(rng, batch, cfg, n_ctx, n_qry)  # the TPU package's init draw
    params = init_params if init_params is not None else init_icl_params(cfg, seed)
    with torch.inference_mode(False), torch.enable_grad():
        net = ICLTransformer(cfg)
        net.load_state_dict(icl_state_dict_from_flax(params, cfg))
        net = net.to(dev).train()
        trainer = MetaTrainer(net, lr, steps, lambda m, t: icl_meta_loss(
            m, t, aux_embed=aux_embed, aux_tau=aux_tau, aux_qc=aux_qc))
        if device_prior:
            from .icl_prior import sample_tasks_device

            gen = torch.Generator(device=dev).manual_seed(seed)
            run_device_chunks(trainer, lambda: sample_tasks_device(
                gen, batch, cfg, n_ctx, n_qry, True, mix_t), steps, chunk, verbose,
                "[icl pretrain/device]")
        else:
            for i in range(steps):
                task = {k: torch.from_numpy(v).to(dev) for k, v in
                        sample_tasks(rng, batch, cfg, n_ctx, n_qry, mix=mix_t).items()}
                loss = trainer.step(task)
                if verbose and (i + 1) % max(1, steps // 10) == 0:
                    print(f"[icl pretrain] step {i + 1}/{steps} loss {float(loss):.4f}")
        return icl_flax_from_state_dict(net.state_dict(), cfg), cfg


def merge_compatible_params(template, path: str, verbose: bool = False):
    """Key-intersection warm start across architecture revisions: leaves of
    `template` (a flax-layout tree) present in the file at `path` with the
    same shape load from it as float32; the others keep their template
    values. Returns a new tree in the template's layout."""
    from .flax_msgpack import read_state, tree_leaves

    stored = dict(tree_leaves(read_state(path)))
    leaves = tree_leaves(template)
    merged, hits = {}, 0
    for k, v in leaves:
        if k in stored and np.shape(stored[k]) == np.shape(v):
            merged[k] = np.asarray(stored[k], np.float32)
            hits += 1
        else:
            merged[k] = v
    if verbose:
        print(f"[icl warm start] {hits}/{len(leaves)} leaves matched "
              f"{path} ({len(stored)} stored)")
    out: dict = {}
    for k, v in merged.items():
        node = out
        for part in k[:-1]:
            node = node.setdefault(part, {})
        node[k[-1]] = v
    return out


def to_host(*tensors) -> list:
    """The tensors as numpy arrays, through one device-to-host copy."""
    flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out


# ----------------------------------------------------------------------
# weights: the bundled assets and their policy
# ----------------------------------------------------------------------

def _assets_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "assets")


def default_asset_path() -> str:
    """Bundled CLASSIFIER asset location; MAD_ICL_ASSET overrides it for
    every ICLClassifier in the process. The regressor has its own asset and
    override (MAD_ICL_REG_ASSET, icl_regression.py)."""
    return os.environ.get("MAD_ICL_ASSET") or os.path.join(_assets_dir(),
                                                           "icl_default.msgpack")


def resolve_asset_params(load_file, env_var: str, bundled_path: str,
                         cfg_is_default: bool, cfg_desc: str):
    """Shared env-override / bundled-asset policy: an env override is loaded
    for ANY config and hard-fails on a dangling path or mismatch; the
    bundled asset applies only to the default config and degrades to None
    (no asset) on a mismatch."""
    env = os.environ.get(env_var)
    if env:
        if not os.path.isfile(env):
            raise FileNotFoundError(
                f"{env_var}={env} does not exist; unset the variable to "
                "use the bundled asset or point it at a real weight file")
        try:
            return load_file(env)
        except Exception as e:
            raise ValueError(
                f"{env_var}={env} does not match {cfg_desc} "
                f"(was it trained with different --d-model/layers?): {e}"
            ) from e
    if not cfg_is_default or not os.path.isfile(bundled_path):
        return None
    try:
        return load_file(bundled_path)
    except ValueError as e:
        import warnings

        warnings.warn(f"ignoring bundled ICL asset {bundled_path}: {e}")
        return None


def float32_tree(tree):
    """The weight tree with every leaf as a float32 numpy array."""
    if isinstance(tree, dict):
        return {k: float32_tree(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def _load_params_file(cfg: ICLConfig, path: str):
    """The flax state at `path`, its shapes checked against `cfg` (ValueError
    with the mismatching leaves), upcast to float32."""
    from ..utils.torch_weights import icl_state_dict_from_flax
    from .flax_msgpack import read_state

    tree = read_state(path)
    icl_state_dict_from_flax(tree, cfg)
    return float32_tree(tree)


def load_default_params(cfg: ICLConfig):
    """Meta-trained weights for `cfg` under the `resolve_asset_params`
    policy; None when no asset applies."""
    return resolve_asset_params(
        lambda p: _load_params_file(cfg, p), "MAD_ICL_ASSET",
        default_asset_path(), cfg == ICLConfig(), f"ICLConfig {cfg}")


def asset_key(est, asset: str):
    """The process-wide weight cache's key: (config, seed, pretrain steps,
    asset path, its mtime), so an override or an overwritten file is not
    masked by an earlier load."""
    try:
        stamp = os.path.getmtime(asset)
    except OSError:
        stamp = None
    return (est._cfg, est.seed, est.pretrain_steps, asset, stamp)


def cached_network(cache: dict, est, params, build):
    """The network for `est`'s weights on `est`'s device, built once: keyed
    by the asset key and the device for bundled weights, by identity and the
    device for caller-given ones (the last few of those are kept)."""
    dev = str(est._device)
    if est.params is None:
        key = est._asset_key() + (dev,)
    else:
        key = ("params", id(est.params), est._cfg, dev)
    hit = cache.get(key)
    if hit is not None and hit[0] is params:
        return hit[1]
    net = build().eval()
    net.load_state_dict(est._state_dict(params))
    net = net.to(est._device)
    if est.params is not None:
        explicit = [k for k in cache if k[0] == "params"]
        for k in explicit[:max(0, len(explicit) + 1 - _EXPLICIT_NETWORKS)]:
            del cache[k]
    cache[key] = (params, net)
    return net


# ----------------------------------------------------------------------
# host preprocessing
# ----------------------------------------------------------------------

class FeaturePreprocessMixin:
    """Train-median imputation + supervised width screen + feature padding
    + optional fitted transform (whiten/quantile/onehot/pairs), shared by
    ICLClassifier and ICLRegressor. Subclasses provide `_cfg`
    (with .max_features) and a `preprocess` attribute."""

    #: "auto" = screen tables wider than the meta-trained feature range
    #: (max_features // 2) down to that width by supervised F-score; an int
    #: forces that width; 0/None disables (over-wide tables then raise in
    #: _pad_features).
    screen_features: Any = "auto"

    def _screen_cap(self) -> int:
        sf = getattr(self, "screen_features", "auto")
        if sf == "auto":
            return max(4, self._cfg.max_features // 2)
        return int(sf) if sf else 0

    def _fit_impute(self, X):
        """Column medians over FINITE train cells."""
        import warnings

        X = np.asarray(X, np.float32)
        finite = np.isfinite(X)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # all-NaN columns -> NaN median
            med = np.nanmedian(np.where(finite, X, np.nan), axis=0)
        self._impute_ = np.nan_to_num(med, nan=0.0, posinf=0.0,
                                      neginf=0.0).astype(np.float32)
        return np.where(finite, X, self._impute_[None])

    def _apply_impute(self, X):
        X = np.asarray(X, np.float32)
        med = getattr(self, "_impute_", None)
        if med is None:  # never fitted (pre-fit helper use): plain cleanup
            return np.nan_to_num(X, nan=0.0, posinf=0.0, neginf=0.0)
        if med.shape[0] != X.shape[1]:
            raise ValueError(
                f"X has {X.shape[1]} features, but this estimator was "
                f"fitted with {med.shape[0]} features")
        return np.where(np.isfinite(X), X, med[None])

    def _fit_screen(self, X, y):
        """Top-k supervised feature screen for tables wider than the
        meta-trained feature range; variance ranking where the supervised
        score is undefined."""
        import warnings

        cap = self._screen_cap()
        if not cap or X.shape[1] <= cap or y is None:
            self._screen_idx_ = None
            return X
        from .estimator import f_classif, f_regression, is_regressor

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # constant columns
            try:
                fn = f_regression if is_regressor(self) else f_classif
                scores = np.nan_to_num(fn(X, np.asarray(y))[0], nan=0.0)
            except Exception:
                scores = X.std(0)
        self._screen_idx_ = np.sort(np.argsort(-scores)[:cap])
        return X[:, self._screen_idx_]

    def _pad_features(self, X):
        X = np.asarray(X, np.float32)
        X = np.nan_to_num(X, nan=0.0, posinf=0.0, neginf=0.0)
        F_ = self._cfg.max_features
        if X.shape[1] > F_:
            raise ValueError(
                f"{X.shape[1]} features > max_features={F_}; raise "
                f"{type(self._cfg).__name__}.max_features or enable the "
                f"width screen (screen_features='auto')")
        return np.pad(X, ((0, 0), (0, F_ - X.shape[1])))

    def _fit_preprocess(self, X, kind="__self__", y=None):
        """Fit imputation + width screen + the optional feature transform on
        the raw training matrix; return the transformed matrix (before
        padding)."""
        if kind == "__self__":
            kind = self.preprocess
        X = self._fit_impute(X)
        X = self._fit_screen(X, y)
        if kind is None:
            self._pre = None
            return X
        if kind == "whiten":
            mu = X.mean(0)
            cov = np.cov(X - mu, rowvar=False)
            cov = np.atleast_2d(cov) + 1e-6 * np.eye(X.shape[1])
            evals, evecs = np.linalg.eigh(cov)
            evals = np.maximum(evals, 1e-4 * evals.max() + 1e-12)
            zca = (evecs / np.sqrt(evals)) @ evecs.T
            self._pre = ("whiten", mu.astype(np.float32), zca.astype(np.float32))
            return (X - mu) @ self._pre[2]
        if kind == "quantile":
            from .estimator import QuantileTransformer

            qt = QuantileTransformer(
                n_quantiles=min(64, len(X)), output_distribution="normal",
                random_state=0).fit(X)
            self._pre = ("quantile", qt)
            return qt.transform(X).astype(np.float32)
        if kind == "onehot":
            from .utils import infer_categorical_features

            cats = infer_categorical_features(X)
            values = [np.unique(X[:, j]) for j in cats]
            self._pre = ("onehot", cats, values)
            return self._onehot_expand(X, cats, values)
        if kind == "pairs":
            if y is None:
                raise ValueError("preprocess='pairs' needs y at fit time")
            sd = (X.std(0) + 1e-6).astype(np.float32)
            # each survivor appends TWO columns (rank-gauss value + sign)
            k = min(8, (self._cfg.max_features - X.shape[1]) // 2)
            sel_i, sel_j, refs = self._pairs_screen(X / sd, y, k)
            self._pre = ("pairs", sd, sel_i, sel_j, refs)
            return self._pairs_apply(X, sd, sel_i, sel_j, refs)
        raise ValueError(f"unknown preprocess={kind!r}")

    @staticmethod
    def _pairs_screen(Z, y, k):
        """Select up to ``k`` product columns Z_i*Z_j (i<=j) whose rank
        correlation with the target clears a Bonferroni-corrected noise
        floor; returns (i_idx, j_idx, sorted-train-product refs)."""
        from scipy.stats import norm

        n, f = Z.shape
        if k <= 0 or f < 2 or n < 16:
            return np.empty(0, np.int64), np.empty(0, np.int64), []
        iu, ju = np.triu_indices(f)
        prods = Z[:, iu] * Z[:, ju]
        r = np.argsort(np.argsort(prods, axis=0), axis=0) / (n - 1) - 0.5
        y = np.asarray(y)
        if y.dtype.kind == "f" and len(np.unique(y)) > max(16, n // 8):
            targets = [(np.argsort(np.argsort(y)) / (n - 1) - 0.5)]
        else:  # class labels: one-vs-rest indicators
            targets = [(y == c).astype(np.float64) for c in np.unique(y)]
        corr = np.zeros(prods.shape[1])
        for t in targets:
            t = t - t.mean()
            denom = np.sqrt((r ** 2).sum(0) * (t ** 2).sum()) + 1e-12
            corr = np.maximum(corr, np.abs(r.T @ t) / denom)
        floor = norm.ppf(1 - 0.01 / len(corr)) / np.sqrt(n)
        sel = np.argsort(-corr)[:k]
        sel = sel[corr[sel] > floor]
        refs = [np.sort(prods[:, j]) for j in sel]
        return iu[sel], ju[sel], refs

    @staticmethod
    def _pairs_apply(X, sd, sel_i, sel_j, refs):
        """Append, per surviving product, its rank-gauss column AND its raw
        sign (squares get no sign column: it is constant)."""
        from scipy.stats import norm

        if len(refs) == 0:
            return X
        Z = X / sd
        cols = [X]
        for i, j, ref in zip(sel_i, sel_j, refs):
            prod = Z[:, i] * Z[:, j]
            pos = np.searchsorted(ref, prod, side="left") + 0.5
            cols.append(norm.ppf(np.clip(pos / (len(ref) + 1), 1e-4,
                                         1 - 1e-4)).astype(np.float32)[:, None])
            if i != j:
                cols.append(np.sign(prod).astype(np.float32)[:, None])
        return np.concatenate(cols, axis=1)

    @staticmethod
    def _onehot_expand(X, cats, values):
        keep = [j for j in range(X.shape[1]) if j not in cats]
        cols = [X[:, keep]] if keep else []
        for j, vals in zip(cats, values):
            cols.append((X[:, j:j + 1] == vals[None, :]).astype(np.float32))
        return np.concatenate(cols, axis=1) if cols else X

    def _apply_preprocess(self, X):
        X = self._apply_impute(X)
        idx = getattr(self, "_screen_idx_", None)
        if idx is not None:
            X = X[:, idx]
        pre = getattr(self, "_pre", None)
        if pre is None:
            return X
        if pre[0] == "whiten":
            return (X - pre[1]) @ pre[2]
        if pre[0] == "onehot":
            return self._onehot_expand(X, pre[1], pre[2])
        if pre[0] == "pairs":
            return self._pairs_apply(X, pre[1], pre[2], pre[3], pre[4])
        return pre[1].transform(X).astype(np.float32)

    @staticmethod
    def context_bucket(n_rows: int, max_context: int) -> int:
        """Smallest power-of-two bucket (>= 64, capped at max_context) that
        holds the context."""
        bucket = 64
        while bucket < n_rows:
            bucket *= 2
        return min(bucket, max_context)


class ICLClassifier(FeaturePreprocessMixin, ClassifierMixin, BaseEstimator):
    """Estimator over the prior-fitted network: fit / predict /
    predict_proba / get_embeddings, with get_params / set_params / clone.

    `preprocess`: 'auto' (default: picked by a stratified holdout at fit,
    with 'onehot' the baseline when integer-coded categorical columns are
    detected and other kinds held to a margin), None, 'whiten', 'quantile',
    'pairs' or 'onehot'; the choice lands in `preprocess_`.

    `n_estimators` (default 8) views run as one batched forward: view 0 is
    the identity, each further view permutes the feature columns and the
    class -> label-embedding assignment; `predict_proba` averages them.

    `device` ("cuda" by default, raising without a card; "cpu" on request)
    is where the forward runs, and where a network is meta-trained when no
    asset applies; the permuted context views stay there between calls.
    Weights are shared process-wide: the bundled asset's (or the
    meta-trained) network is built once per (config, seed,
    pretrain_steps, asset, device).
    """

    _param_cache: dict = {}
    _model_cache: dict = {}

    def __init__(self, params=None, cfg: ICLConfig | None = None,
                 pretrain_steps: int = 300, seed: int = 0,
                 softmax_temperature: float = 1.0,
                 context_size: int | None = None,
                 preprocess: str | None = "auto",
                 n_estimators: int = 8,
                 screen_features="auto",
                 embedding_kind: str = "rich",
                 device: str = "cuda"):
        self.params = params
        self.cfg = cfg
        self.pretrain_steps = pretrain_steps
        self.seed = seed
        self.softmax_temperature = softmax_temperature
        self.context_size = context_size
        self.preprocess = preprocess
        self.n_estimators = n_estimators
        self.screen_features = screen_features
        self.embedding_kind = embedding_kind
        self.device = device

    @property
    def _cfg(self) -> ICLConfig:
        return self.cfg or ICLConfig()

    def _asset_key(self):
        return asset_key(self, default_asset_path())

    def _ensure_params(self):
        """The weight tree: `params`, else the bundled asset's, else one
        meta-trained here on the estimator's device (`pretrain_icl` with
        `pretrain_steps` and `seed`); cached process-wide by the asset key."""
        if self.params is not None:
            return self.params
        key = self._asset_key()
        if key not in ICLClassifier._param_cache:
            bundled = load_default_params(self._cfg)
            if bundled is None:
                bundled, _ = pretrain_icl(self._cfg, steps=self.pretrain_steps,
                                          seed=self.seed, device=self.device)
            ICLClassifier._param_cache[key] = bundled
        return ICLClassifier._param_cache[key]

    def _state_dict(self, params):
        from ..utils.torch_weights import icl_state_dict_from_flax

        return icl_state_dict_from_flax(params, self._cfg)

    def _network(self) -> ICLTransformer:
        return cached_network(ICLClassifier._model_cache, self, self._ensure_params(),
                              lambda: ICLTransformer(self._cfg))

    def _select_preprocess(self, X, y):
        """Pick the feature transform with a stratified holdout. Ties
        resolve to the earlier candidate; with categorical columns detected
        'onehot' is the baseline, and rotating/distorting transforms must
        clear it by a margin of about two holdout samples."""
        from .estimator import train_test_split
        from .utils import infer_categorical_features

        base_kind = "onehot" if infer_categorical_features(X) else None
        y = np.asarray(y)
        if len(X) < 24:
            return base_kind  # too few rows for a meaningful holdout
        idx = np.arange(len(X))
        try:
            tr, vl = train_test_split(idx, test_size=0.25,
                                      random_state=self.seed, stratify=y)
        except ValueError:  # a class with < 2 members
            tr, vl = train_test_split(idx, test_size=0.25,
                                      random_state=self.seed)
        kinds = [base_kind, None, "whiten", "quantile"]
        kinds = list(dict.fromkeys(kinds))  # drop the duplicate None case
        if X.shape[1] >= 2 and X.shape[1] + 2 <= self._cfg.max_features:
            kinds.append("pairs")  # room for >=1 screened interaction (2 cols)
        scores = {}
        for kind in kinds:
            sub = ICLClassifier(
                params=self.params, cfg=self.cfg,
                pretrain_steps=self.pretrain_steps, seed=self.seed,
                softmax_temperature=self.softmax_temperature,
                context_size=self.context_size, preprocess=kind,
                n_estimators=self.n_estimators,
                screen_features=self.screen_features, device=self.device)
            try:
                sub.fit(X[tr], y[tr])
                scores[kind] = float((sub.predict(X[vl]) == y[vl]).mean())
            except (ValueError, np.linalg.LinAlgError):
                continue
        if not scores:
            return base_kind
        margin = max(0.02, 2.0 / max(len(vl), 1))
        base = scores.get(base_kind, -1.0)
        best_kind, best_acc = base_kind, base
        for kind in kinds:
            if kind == base_kind:
                continue
            if scores.get(kind, -1.0) > max(base + margin, best_acc):
                best_kind, best_acc = kind, scores[kind]
        return best_kind

    def fit(self, X, y):
        self._device = resolve_device(self.device)
        self._ensure_params()  # no weights apply: raise before any work
        # NaN/inf cells survive to _fit_preprocess, which imputes them
        X = np.asarray(X, np.float32)
        y = np.asarray(y)
        kind = self.preprocess
        if kind == "auto":
            kind = self._select_preprocess(X, y)
        self.preprocess_ = kind
        Xp = self._fit_preprocess(X, kind, y=y)
        f_real = Xp.shape[1]  # width before padding: views permute only this
        X = self._pad_features(Xp)
        self.classes_, y_idx = np.unique(y, return_inverse=True)
        if len(self.classes_) > self._cfg.max_classes:
            raise ValueError(
                f"{len(self.classes_)} classes > max_classes={self._cfg.max_classes}"
                " — wrap with ManyClassClassifier")
        n_max = self._cfg.max_context
        if self.context_size is not None:
            n_max = min(n_max, int(self.context_size))
        if len(X) > n_max:
            # class-stratified context subsampling: slots proportional to
            # class frequency, every class at least one
            rng = np.random.default_rng(self.seed)
            n_cls = len(self.classes_)
            counts = np.bincount(y_idx, minlength=n_cls)
            quota = np.maximum(1, np.floor(counts / len(X) * n_max)).astype(int)
            quota = np.minimum(quota, counts)
            while quota.sum() < n_max:
                room = counts - quota
                if room.max() <= 0:
                    break
                quota[np.argmax(room)] += 1
            while quota.sum() > n_max and quota.max() > 1:
                quota[np.argmax(quota)] -= 1
            sel = np.concatenate([
                rng.choice(np.where(y_idx == c)[0], quota[c], replace=False)
                for c in range(n_cls) if quota[c] > 0])
            rng.shuffle(sel)
            sel = sel[:n_max]
            X, y_idx = X[sel], y_idx[sel]
        pad = self.context_bucket(len(X), self._cfg.max_context) - len(X)
        self._fitted = {
            "x_ctx": np.pad(X, ((0, pad), (0, 0)))[None],
            "y_ctx": np.pad(y_idx, (0, pad)).astype(np.int32)[None],
            "ctx_mask": np.pad(np.ones(len(X), np.float32), (0, pad))[None],
        }
        # ensemble views (identity first): feature-column permutations over
        # the real width + class -> embedding-row permutations, from a
        # stream distinct from the context subsampler's
        k = len(self.classes_)
        V = max(1, int(self.n_estimators))
        rng = np.random.default_rng((self.seed, 101))
        fp, cp = [np.arange(self._cfg.max_features)], [np.arange(k)]
        for _ in range(V - 1):
            p = np.arange(self._cfg.max_features)
            p[:f_real] = rng.permutation(f_real)
            fp.append(p)
            cp.append(rng.permutation(k))
        self._views = (np.stack(fp), np.stack(cp))
        # per-feature categorical indicator, on the PREPROCESSED matrix
        cat_vec = np.zeros(self._cfg.max_features, np.float32)
        if self._cfg.cat_input and f_real:
            from .utils import infer_categorical_features

            for j in infer_categorical_features(Xp):
                cat_vec[j] = 1.0
        # the permuted context views are fit-time constants: built and
        # uploaded once, so predict calls only move the queries
        x_ctx = self._fitted["x_ctx"][0]
        y_ctx = self._fitted["y_ctx"][0]
        mask = self._fitted["ctx_mask"][0]
        dev = self._device
        self._views_dev = (
            torch.from_numpy(np.stack([x_ctx[:, p] for p in fp])).to(dev),
            torch.from_numpy(np.stack([c[y_ctx] for c in cp]).astype(np.int64)).to(dev),
            # a copy: with V = 1 a broadcast view would alias the fitted mask
            torch.from_numpy(np.repeat(mask[None], V, 0)).to(dev),
            torch.from_numpy(np.stack([cat_vec[p] for p in fp])).to(dev))
        return self

    def _run(self, X, want_ctx: bool = False, want_tap: bool = False):
        """One batched forward over all ensemble views.

        Returns (logits (V, M, k) with class columns un-permuted back to
        canonical `classes_` order, per-view query embeddings (V, M, d)[,
        identity-view context embeddings (N, d) when ``want_ctx``][,
        per-view penultimate-layer query states (V, M, d) when
        ``want_tap``]); everything comes to the host in one copy."""
        if getattr(self, "_fitted", None) is None:
            raise RuntimeError("fit() first")
        net = self._network()
        fp, cp = self._views
        V = len(fp)
        Xq = self._pad_features(self._apply_preprocess(X))
        x_ctx_v, y_ctx_v, mask_v, cat_v = self._views_dev
        xq = torch.from_numpy(np.stack([Xq[:, p] for p in fp])).to(self._device)
        with torch.inference_mode():
            xc, xq = _zscore_by_ctx(x_ctx_v, xq, mask_v)
            outs = net(xc, y_ctx_v, mask_v, xq, cat_v, return_penult=want_tap)
            wanted = [outs[0], outs[1]]
            if want_ctx:
                wanted.append(outs[2][0])
            if want_tap:
                wanted.append(outs[3])
            host = to_host(*wanted)
        logits = host[0]
        canon = np.stack([logits[v][:, cp[v]] for v in range(V)])
        return (canon,) + tuple(host[1:])

    def predict_proba(self, X):
        logits, _ = self._run(X)  # (V, M, k), already canonical order
        logits = logits / max(float(self.softmax_temperature), 1e-6)
        e = np.exp(logits - logits.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).mean(0)

    def predict(self, X):
        return self.classes_[np.argmax(self.predict_proba(X), axis=1)]

    def _class_columns(self, values):
        """Scatter per-class columns (M, k) into a canonical (M,
        max_classes) block: addressed by the class LABEL when every label
        is a small non-negative integer (so K-fold refits that see
        different class subsets write each class to the same column), by
        `classes_` position otherwise."""
        M, k = values.shape
        C = self._cfg.max_classes
        out = np.zeros((M, C), values.dtype)
        cls = self.classes_
        try:
            idx = np.asarray(cls, np.int64)
            ok = (np.asarray(cls, np.float64) == idx).all() and \
                (idx >= 0).all() and (idx < C).all()
        except (ValueError, TypeError):
            ok = False
        cols = idx if ok else np.arange(k)
        out[:, cols] = values
        return out

    def get_embeddings(self, X, data_source: str = "test"):
        """(1, n, d) query representations (TabPFN v2's get_embeddings
        shape). `embedding_kind`:

        - 'rich' (default): view-averaged final hidden state (d_model)
          ++ canonical view-mean class logits (max_classes) ++ cosine of the
          query state to per-class context prototypes (max_classes) ++ the
          kNN evidence block (2 max_classes: per-class top-1 and mean top-3
          query -> context cosines);
        - 'compact': the canonical blocks only (4 max_classes);
        - 'rich2': 'rich' plus the view-averaged penultimate-layer query
          state (2 d_model + the canonical blocks);
        - 'hidden': the identity view's final hidden state only.
        """
        kind = getattr(self, "embedding_kind", "rich")
        if kind == "hidden":
            _, emb = self._run(X)
            return emb[:1]
        if kind not in ("rich", "rich2", "compact"):
            raise ValueError(f"unknown embedding_kind={kind!r}")
        if kind == "rich2":
            canon, emb, ctx, h_pen = self._run(X, want_ctx=True, want_tap=True)
        else:
            canon, emb, ctx = self._run(X, want_ctx=True)
        k = len(self.classes_)
        logit_mean = self._class_columns(canon.mean(0)[:, :k])
        y_ctx = self._fitted["y_ctx"][0]
        mask = self._fitted["ctx_mask"][0]
        protos = np.zeros((k, ctx.shape[1]), np.float32)
        for c in range(k):
            w = mask * (y_ctx == c)
            protos[c] = (ctx * w[:, None]).sum(0) / max(w.sum(), 1.0)
        q0 = emb[0]  # identity view, same geometry as the prototypes
        qn = q0 / np.maximum(np.linalg.norm(q0, axis=1, keepdims=True), 1e-6)
        pn = protos / np.maximum(
            np.linalg.norm(protos, axis=1, keepdims=True), 1e-6)
        cos = self._class_columns(qn @ pn.T)
        ctx_n = ctx / np.maximum(
            np.linalg.norm(ctx, axis=1, keepdims=True), 1e-6)
        sims = qn @ ctx_n.T  # (M, N)
        top1 = np.zeros((len(q0), k), np.float32)
        top3 = np.zeros((len(q0), k), np.float32)
        for c in range(k):
            cols = (mask > 0) & (y_ctx == c)
            if not cols.any():
                continue
            sc = np.sort(sims[:, cols], axis=1)[:, ::-1]
            top1[:, c] = sc[:, 0]
            top3[:, c] = sc[:, :min(3, sc.shape[1])].mean(1)
        knn = np.concatenate([self._class_columns(top1),
                              self._class_columns(top3)], axis=1)
        blocks = [logit_mean, cos, knn]
        if kind == "rich":
            blocks = [emb.mean(0)] + blocks
        elif kind == "rich2":
            blocks = [emb.mean(0), h_pen.mean(0)] + blocks
        return np.concatenate(blocks, axis=1)[None]
