"""The synthetic-task prior of ICL meta-training, sampled on the device
(port of the TPU package's tabular/icl_prior.py).

`icl.sample_tasks` draws meta-training tasks with host numpy, one task at
a time; here the same random-function prior is a batch of torch ops on the
device, drawing from one `torch.Generator` there, so a meta-training step
uploads nothing. All B tasks of a draw are built at once: every task
computes all five families, and its drawn family picks one, as the TPU
package's vmapped sampler does.

Parity with the host sampler is in distribution, not in stream: the same
five families with the same mixture weights, the same feature / class /
context-length ranges and the same label noise, but the port's own draws.

Dynamic task ingredients (feature count f, class count c, latent rank k,
valid context length) become static-shape masks: features >= f are
zeroed, class cut points >= c - 1 are +inf, context rows >= n_valid are
masked and zeroed. The shapes never change from draw to draw.

The correlated-latent family draws its whitened score direction from
N(0, cov^-1) with a Cholesky solve of the generative model's covariance
plus 1e-6 I, as the TPU package does, here in float64; a task whose
factorization still fails (`cholesky_ex` reports it, nothing raises)
scores on its latents instead. Class frequencies of the cluster family
come from a Dirichlet, drawn as normalized gammas (Marsaglia and Tsang's
method, a fixed number of rounds so that no step waits on the host).
"""

from __future__ import annotations

import math

import torch

#: rounds of the gamma sampler's rejection step: each accepts with
#: probability > 0.95 for shape >= 1, so 8 rounds leave < 1e-10 undecided
_GAMMA_ROUNDS = 8


class _Draws:
    """Uniform, normal and integer draws from one generator on its device."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen
        self.device = gen.device

    def uniform(self, shape, lo=0.0, hi=1.0):
        u = torch.rand(shape, generator=self.gen, device=self.device)
        return u * (hi - lo) + lo

    def normal(self, shape):
        return torch.randn(shape, generator=self.gen, device=self.device)

    def randint(self, low, high, shape):
        """Integers in [low, high) (low, high: ints or tensors that
        broadcast to `shape`)."""
        u = self.uniform(shape)
        low = torch.as_tensor(low, device=self.device)
        high = torch.as_tensor(high, device=self.device)
        v = low + torch.floor(u * (high - low).to(u.dtype)).long()
        return torch.minimum(v, high - 1)

    def gamma(self, alpha, shape):
        """Gamma(alpha, 1) draws; `alpha` broadcasts to `shape`."""
        a = alpha.expand(shape)
        boost = a < 1
        d = torch.where(boost, a + 1, a) - 1.0 / 3.0
        c = 1.0 / torch.sqrt(9.0 * d)
        out, done = d.clone(), torch.zeros(shape, dtype=torch.bool, device=self.device)
        for _ in range(_GAMMA_ROUNDS):
            x = self.normal(shape)
            v = (1.0 + c * x) ** 3
            u = self.uniform(shape)
            ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                            + d * torch.log(v.clamp(min=1e-30)))
            out = torch.where(ok & ~done, d * v, out)
            done = done | ok
        return torch.where(boost, out * self.uniform(shape) ** (1.0 / a), out)


def _mask_ctx(r: _Draws, batch, n_ctx, var_ctx):
    """The valid-context mask (B, n_ctx): a length in [16, n_ctx] per task
    with ``var_ctx`` (and n_ctx > 16), else all valid."""
    mask = torch.ones((batch, n_ctx), device=r.device)
    if var_ctx and n_ctx > 16:
        n_valid = r.randint(16, n_ctx + 1, (batch, 1))
        mask = (torch.arange(n_ctx, device=r.device)[None] < n_valid).float()
    return mask


def _bucket(r: _Draws, score, c, C: int):
    """Labels of `score` (B, n) at random cut quantiles: sorted uniforms in
    [0.05, 0.95], np.quantile's linear interpolation and np.digitize's
    rule; C - 1 physical cuts, those >= c - 1 at +inf."""
    b, n = score.shape
    s = torch.sort(score, dim=1).values
    u = r.uniform((b, C - 1), 0.05, 0.95)
    live = torch.arange(C - 1, device=r.device)[None] < (c[:, None] - 1)
    u = torch.sort(torch.where(live, u, math.inf), dim=1).values
    finite = torch.isfinite(u)
    pos = torch.where(finite, u, 0.0) * (n - 1)
    lo = torch.floor(pos).long().clamp(0, n - 1)
    hi = (lo + 1).clamp(0, n - 1)
    frac = pos - lo
    qs = s.gather(1, lo) * (1 - frac) + s.gather(1, hi) * frac
    qs = torch.where(finite, qs, math.inf)
    return (score[:, :, None] >= qs[:, None, :]).sum(-1)


def _columns(x, idx):
    """x[b, :, idx[b]] for (B, n, F) `x` and (B,) `idx`."""
    return x.gather(2, idx[:, None, None].expand(x.shape[0], x.shape[1], 1))[..., 0]


def _quantized(r: _Draws, xs, f, feat):
    """Quantize a random set of n_cat in [0, max(1, f // 3)] real columns
    to {0, 1, 2}; returns (xs masked to the real columns, the column mask)."""
    b, _, F = xs.shape
    n_cat = r.randint(0, torch.clamp(f // 3, min=1) + 1, (b,))
    rank = torch.argsort(torch.argsort(r.uniform((b, F)) + (1 - feat) * 1e9, dim=1), dim=1)
    catm = (rank < n_cat[:, None]) & (feat > 0)
    quant = (xs > -0.5).float() + (xs > 0.5).float()
    return torch.where(catm[:, None, :], quant, xs) * feat[:, None, :], catm.float()


def _family_correlated(r: _Draws, n, F, f, feat):
    """Observed features = a mix of k < f latents + small noise; the score
    is on the latents or (half the tasks) on a whitened direction drawn
    from N(0, cov^-1) of the generative model's covariance."""
    b = f.shape[0]
    Kp = max(1, F // 2)
    k = r.randint(1, torch.clamp(f // 2, min=2) + 1, (b,))
    kmask = (torch.arange(Kp, device=r.device)[None] < k[:, None]).float()
    z = r.normal((b, n, Kp)) * kmask[:, None, :]
    mix = r.normal((b, Kp, F)) * kmask[:, :, None] * feat[:, None, :]
    eps = r.uniform((b,), 0.02, 0.3)
    xs = z @ mix + eps[:, None, None] * r.normal((b, n, F)) * feat[:, None, :]
    score_lat = (z @ (r.normal((b, Kp)) * kmask)[:, :, None])[..., 0]
    m64 = mix.double()
    noise = torch.diag_embed((eps.double() ** 2)[:, None] * feat.double())
    cov = (m64.transpose(1, 2) @ m64 + noise
           + 1e-6 * torch.eye(F, dtype=torch.float64, device=r.device))
    chol, info = torch.linalg.cholesky_ex(cov)
    g = r.normal((b, F)).double()
    w = torch.linalg.solve_triangular(chol.transpose(1, 2), g[:, :, None], upper=True)[..., 0]
    ok = info == 0
    w = torch.where(ok[:, None], w, 0.0).float()
    score_wht = ((xs - xs.mean(1, keepdim=True)) @ w[:, :, None])[..., 0]
    use_lat = (r.uniform((b,)) < 0.5) | ~ok
    return xs, torch.where(use_lat[:, None], score_lat, score_wht)


def _family_pairwise(r: _Draws, n, F, f, feat, hard):
    """Score dominated by products of feature pairs (1-3 pairs); with
    `hard` (per task) the products are SIGN products."""
    b = f.shape[0]
    xs = r.normal((b, n, F)) * feat[:, None, :]
    n_pairs = r.randint(1, 4, (b,))
    lin = (xs @ (r.normal((b, F)) * feat)[:, :, None])[..., 0]
    score = torch.where(hard, 0.0, 0.2)[:, None] * lin
    for p in range(3):
        i = r.randint(0, f, (b,))
        jr = r.randint(0, torch.clamp(f - 1, min=1), (b,))
        j = jr + (jr >= i).long()
        g = r.normal((b,))
        raw = _columns(xs, i) * _columns(xs, j)
        term = g[:, None] * torch.where(hard[:, None], torch.sign(raw), raw)
        score = score + torch.where((p < n_pairs)[:, None], term, 0.0)
    return xs, score


def _family_periodic(r: _Draws, n, F, f, feat):
    """Sinusoids of single features (1-2 waves) + a small linear term."""
    b = f.shape[0]
    xs = r.normal((b, n, F)) * feat[:, None, :]
    n_waves = r.randint(1, 3, (b,))
    score = 0.1 * (xs @ (r.normal((b, F)) * feat)[:, :, None])[..., 0]
    for p in range(2):
        i = r.randint(0, f, (b,))
        w = r.uniform((b,), 1.0, 4.0)
        ph = r.uniform((b,), 0.0, 2 * math.pi)
        g = r.normal((b,))
        term = g[:, None] * torch.sin(w[:, None] * _columns(xs, i) + ph[:, None])
        score = score + torch.where((p < n_waves)[:, None], term, 0.0)
    return xs, score


def _mlp_score(r: _Draws, xs, F):
    """A random shallow tanh MLP of 8 units + 0.3 of a linear term."""
    b = xs.shape[0]
    h1 = torch.tanh(xs @ r.normal((b, F, 8)) + r.normal((b, 1, 8)))
    return (h1 @ r.normal((b, 8, 1)))[..., 0] + 0.3 * (xs @ r.normal((b, F, 1)))[..., 0]


def _pick(kind, thresholds, *options):
    """options[i] per task, i = the number of thresholds `kind` reaches."""
    idx = sum((kind >= t).long() for t in thresholds)
    stacked = torch.stack(options, 1)  # (B, 5, ...)
    shape = (idx.shape[0], 1) + stacked.shape[2:]
    return stacked.gather(1, idx.view(-1, *([1] * (stacked.dim() - 1))).expand(shape))[:, 0]


def _class_tasks(r: _Draws, batch, n, F, C, thresholds):
    """(x (B, n, F), labels (B, n), categorical mask (B, F)): the five
    families of icl.sample_tasks, one drawn per task."""
    f = r.randint(3, max(4, F // 2) + 1, (batch,))
    if C > 2:
        c = torch.where(r.uniform((batch,)) < 0.5, torch.full_like(f, 2),
                        r.randint(2, C + 1, (batch,)))
    else:
        c = r.randint(2, C + 1, (batch,))
    kind = r.uniform((batch,))
    feat = (torch.arange(F, device=r.device)[None] < f[:, None]).float()

    # cluster: class-conditional gaussians, Dirichlet class frequencies,
    # a few columns quantized
    sep = r.uniform((batch,), 0.5, 3.0)
    centers = r.normal((batch, C, F)) * sep[:, None, None]
    alpha = r.uniform((batch, 1), 0.4, 3.0)
    cls_valid = (torch.arange(C, device=r.device)[None] < c[:, None]).float()
    g = r.gamma(alpha, (batch, C)) * cls_valid
    probs = g / g.sum(1, keepdim=True).clamp(min=1e-9)
    probs = 0.9 * probs + 0.1 * cls_valid / c[:, None].float()
    lab_cl = torch.multinomial(probs, n, replacement=True, generator=r.gen)
    xs_cl = (centers.gather(1, lab_cl[:, :, None].expand(batch, n, F))
             + r.normal((batch, n, F))) * feat[:, None, :]
    xs_cl, catm_cl = _quantized(r, xs_cl, f, feat)

    xs_co, score_co = _family_correlated(r, n, F, f, feat)
    hard = r.uniform((batch,)) < 0.5
    xs_pw, score_pw = _family_pairwise(r, n, F, f, feat, hard)
    xs_pe, score_pe = _family_periodic(r, n, F, f, feat)

    # shallow MLP over features with some columns quantized
    xs_m, catm = _quantized(r, r.normal((batch, n, F)), f, feat)
    score_m = _mlp_score(r, xs_m, F)

    xs = _pick(kind, thresholds, xs_cl, xs_co, xs_pw, xs_pe, xs_m)
    zeros = torch.zeros_like(catm)
    cat = _pick(kind, thresholds, catm_cl, zeros, zeros, zeros, catm)
    lab = _pick(kind, thresholds, lab_cl, _bucket(r, score_co, c, C),
                _bucket(r, score_pw, c, C), _bucket(r, score_pe, c, C),
                _bucket(r, score_m, c, C))
    # label noise at a rate drawn per task, mostly near zero
    rate = torch.where(r.uniform((batch,)) < 0.6, r.uniform((batch,), 0.0, 0.02),
                       r.uniform((batch,), 0.02, 0.12))
    flip = r.uniform((batch, n)) < rate[:, None]
    lab = torch.where(flip, r.randint(0, c[:, None], (batch, n)), lab)
    return xs, lab, cat


def sample_tasks_device(gen: torch.Generator, batch: int, cfg, n_ctx: int, n_qry: int,
                        var_ctx: bool = True, mix: tuple | None = None) -> dict:
    """icl.sample_tasks's dict of (B, ...) task tensors, drawn on
    `gen`'s device: x_ctx (B, n_ctx, F) float32, y_ctx (B, n_ctx) int64,
    ctx_mask (B, n_ctx), x_qry, y_qry, cat_mask (B, F). ``mix`` overrides
    the five family weights (icl.DEFAULT_FAMILY_MIX)."""
    from .icl import DEFAULT_FAMILY_MIX, _mix_thresholds

    r = _Draws(gen)
    thresholds = _mix_thresholds(DEFAULT_FAMILY_MIX if mix is None else mix)
    n = n_ctx + n_qry
    x, y, cat = _class_tasks(r, batch, n, cfg.max_features, cfg.max_classes, thresholds)
    mask = _mask_ctx(r, batch, n_ctx, var_ctx)
    return {"x_ctx": x[:, :n_ctx] * mask[..., None], "y_ctx": y[:, :n_ctx] * mask.long(),
            "ctx_mask": mask, "x_qry": x[:, n_ctx:], "y_qry": y[:, n_ctx:],
            "cat_mask": cat}


#: cumulative family cut points of the regression prior (linear,
#: correlated, pairwise, periodic, MLP)
REG_THRESHOLDS = (0.25, 0.45, 0.60, 0.75)


def sample_reg_tasks_device(gen: torch.Generator, batch: int, cfg, n_ctx: int,
                            n_qry: int, var_ctx: bool = True) -> dict:
    """The continuous-target twin for the regression network (`cfg` a
    RegICLConfig; only max_features is read): the classifier prior's
    function families without the bucketing, plus pure-linear tasks, and
    an observation noise of 1-30 % of the score's spread. y_ctx is zero
    on masked context rows."""
    r = _Draws(gen)
    F = cfg.max_features
    n = n_ctx + n_qry
    f = r.randint(3, max(4, F // 2) + 1, (batch,))
    kind = r.uniform((batch,))
    feat = (torch.arange(F, device=r.device)[None] < f[:, None]).float()
    xs_li = r.normal((batch, n, F)) * feat[:, None, :]
    score_li = (xs_li @ (r.normal((batch, F)) * feat)[:, :, None])[..., 0]
    xs_co, score_co = _family_correlated(r, n, F, f, feat)
    no_sign = torch.zeros((batch,), dtype=torch.bool, device=r.device)
    xs_pw, score_pw = _family_pairwise(r, n, F, f, feat, no_sign)
    xs_pe, score_pe = _family_periodic(r, n, F, f, feat)
    xs_m = r.normal((batch, n, F)) * feat[:, None, :]
    score_m = _mlp_score(r, xs_m, F)
    x = _pick(kind, REG_THRESHOLDS, xs_li, xs_co, xs_pw, xs_pe, xs_m)
    score = _pick(kind, REG_THRESHOLDS, score_li, score_co, score_pw, score_pe, score_m)
    noise_frac = r.uniform((batch, 1), 0.01, 0.3)
    sd = torch.sqrt(score.var(1, unbiased=False, keepdim=True).clamp(min=1e-9))
    y = score + noise_frac * sd * r.normal((batch, n))
    mask = _mask_ctx(r, batch, n_ctx, var_ctx)
    return {"x_ctx": x[:, :n_ctx] * mask[..., None], "y_ctx": y[:, :n_ctx] * mask,
            "ctx_mask": mask, "x_qry": x[:, n_ctx:], "y_qry": y[:, n_ctx:]}
