"""Truth-free posterior post-processing for point-estimator clouds (port of
``gennet_tpu.eval.posterior_post``; the docstrings there give each route's
measured motivation).

The posterior is CNN(G draws). Every route here uses only the measured
data, the forward model ``synth_fn`` and the CNN itself, no ground truth:
round-trip self-calibration, parametric-bootstrap calibration,
maximum-likelihood recentering (Adam through the forward model, so
through the phasor kernel's VJP on the card), residual-likelihood
importance resampling (plain, smoothed, and with the pool's KDE as
proposal), and ELBO scoring and selection over candidate clouds.

Conventions of the port:

- Clouds come in as numpy arrays or tensors of shape (N, P) and go out as
  float32 numpy arrays, as the reference's do. ``synth_fn`` maps (N, P)
  parameters (numpy or tensor) to (N, n_pix) float32 templates on its own
  device, and the arithmetic runs there in float32, as the reference's does
  on its device.
- Random draws come from an explicit ``torch.Generator``. Every function
  that draws also takes the draw itself as an optional argument (``noise``,
  ``jitter``, ``u0``, ``idx``, ``normal``, or a ``draws`` dict for the
  functions that call others), so a test can pass in JAX's draw.
- Reference faults are reproduced, not fixed: :func:`kde_is_resample`'s
  bandwidth exponent is −2/(p+2), as in the reference (its docstring says
  Scott's rule, −2/(p+4)).
"""

import numpy as np
import torch

from gennet_tpu_torch.runtime import graphs
from gennet_tpu_torch.runtime.optim import adam


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.array(x)


def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device).to(device)


def _uniform(gen: torch.Generator) -> float:
    return float(torch.rand((), generator=gen, device=gen.device))


def _sq_resid(wf: torch.Tensor, measured) -> torch.Tensor:
    """Σ_t (d − s(θ))² per row, on wf's device."""
    d = _f32(measured, wf.device)[None, :]
    return torch.sum((d - wf) ** 2, dim=1)


def _logl(wf: torch.Tensor, measured, n_sig: float) -> torch.Tensor:
    """logL = −½‖d − s(θ)‖²/σ², with non-finite rows at −inf."""
    logl = -0.5 * _sq_resid(wf, measured) / (n_sig**2)
    return torch.where(torch.isfinite(logl), logl, torch.full_like(logl, -torch.inf))


def _systematic(w: torch.Tensor, n_out: int, u0: float) -> torch.Tensor:
    """Systematic resampling indices of the normalised weights ``w``."""
    pts = (u0 + torch.arange(n_out, dtype=w.dtype, device=w.device)) / n_out
    idx = torch.searchsorted(torch.cumsum(w, 0), pts)
    return torch.clamp(idx, 0, w.shape[0] - 1)


def self_calibrate(samples, synth_fn, cnn_fn, gen: torch.Generator, n_sig: float,
                   rounds: int = 1, noise=None) -> np.ndarray:
    """Debias a cloud by its measured round-trip shift: θ_{k+1} = y − b̄(θ_k),
    with b̄ the mean shift of cnn(s(θ_k) + noise) − θ_k.

    ``noise``: optional (rounds, N, n_pix) unit normal draws."""
    y = _f32(_np(samples))
    s = y
    for r in range(max(rounds, 0)):
        wf = synth_fn(s)
        y, s = y.to(wf.device), s.to(wf.device)
        eps = _f32(noise[r], wf.device) if noise is not None else _normal(gen, wf.shape, wf.device)
        wf = wf + n_sig * eps
        rt = _f32(cnn_fn(wf), wf.device)
        delta = torch.mean(rt - s, dim=0)
        s = y - delta[None, :]
    return _np(s)


def bootstrap_calibrate(samples, synth_fn, cnn_fn, gen: torch.Generator, n_sig: float,
                        shrink: bool = True, noise=None) -> np.ndarray:
    """Debias and dispersion-match a cloud to its parametric bootstrap
    r = cnn(s(θ̄) + noise_i): subtract mean(r) − θ̄ and, when the cloud is
    wider than std(r), shrink it about its mean (never widen).

    ``noise``: optional (N, n_pix) unit normal draws."""
    y = _f32(_np(samples))
    center = torch.mean(y, dim=0)
    wf = synth_fn(center[None, :])
    y, center = y.to(wf.device), center.to(wf.device)
    wf = wf.expand((y.shape[0],) + tuple(wf.shape[1:]))
    eps = _f32(noise, wf.device) if noise is not None else _normal(gen, wf.shape, wf.device)
    wf = wf + n_sig * eps
    r = _f32(cnn_fn(wf), wf.device)
    delta = torch.mean(r, dim=0) - center
    ratio = torch.std(y, dim=0, correction=0) / torch.clamp_min(torch.std(r, dim=0, correction=0),
                                                               1e-12)
    scale = 1.0 / torch.clamp_min(ratio, 1.0) if shrink else 1.0
    out = (center - delta)[None, :] + (y - center[None, :]) * scale
    return _np(out)


def ml_recenter(samples, synth_fn, measured, gen: torch.Generator, steps: int = 300,
                n_starts: int = 8, lr: float = 0.1, jitter=None) -> np.ndarray:
    """Shift a cloud so its centre sits at the maximum-likelihood point.

    θ* = argmin ‖d − s(θ)‖² by Adam (optax's defaults) from the ``n_starts``
    starts: half the best-likelihood draws, half 2σ-jittered around the
    centre; in z-units, θ = θ0 + z·σ_cloud. The gradient runs through
    ``synth_fn`` with autograd, so through the phasor kernel's VJP on the
    card. The cloud is then translated so its mean is the best finite
    candidate among the refined and unrefined starts (no shift if none is
    finite); dispersion is untouched.

    The Adam steps are the reference's ``lax.scan``: on a card, replays of
    one captured step (the synthesis, its gradient and a capturable Adam
    on a fixed ``z``; :class:`~gennet_tpu_torch.runtime.graphs.StepGraph`),
    so ``synth_fn`` must make no host copy or sync; elsewhere eager steps.

    ``jitter``: optional (max(k//2, 1), P) unit normal draws.
    """
    s = _f32(_np(samples))
    with torch.no_grad():
        wf = synth_fn(s)
        s = s.to(wf.device)
        d = _f32(measured, wf.device)[None, :]
        logl = -0.5 * torch.sum((d - wf) ** 2, dim=1)
        k = min(n_starts, s.shape[0])
        sig = torch.clamp_min(torch.std(s, dim=0, correction=0), 1e-12)
        center0 = torch.mean(s, dim=0)
        shape = (max(k // 2, 1), s.shape[1])
        eps = _f32(jitter, s.device) if jitter is not None else _normal(gen, shape, s.device)
        jit = center0[None, :] + 2.0 * sig[None, :] * eps
        order = torch.argsort(-logl, stable=True)
        starts = torch.cat([s[order[: k - jit.shape[0]]], jit])

    z = torch.zeros_like(starts, requires_grad=True)
    opt = adam([z], lr, 0.9)

    def step():
        # per-start residual power; the sum is fine, the starts are independent
        loss = torch.sum((d - synth_fn(starts + z * sig[None, :])) ** 2)
        # a forward model that ignores θ has a zero gradient, as under jax.grad
        g = torch.autograd.grad(loss, z, allow_unused=True)[0] if loss.requires_grad else None
        z.grad = torch.zeros_like(z) if g is None else g
        opt.step()
        return {"loss": loss.detach()}

    graph = graphs.StepGraph("ml_recenter step", graphs.graphable(z.device))
    graph.run(steps, step, lambda: [z, starts, sig, d, *graphs.optimizer_tensors(opt)])

    with torch.no_grad():
        theta = torch.cat([starts + z * sig[None, :], starts])
        final = torch.sum((d - synth_fn(theta)) ** 2, dim=1)
        finite_rows = torch.all(torch.isfinite(theta), dim=1)
        final = torch.where(torch.isfinite(final) & finite_rows, final,
                            torch.full_like(final, torch.inf))
        best = theta[torch.argmin(final)]
        shift = best - torch.mean(s, dim=0)
        ok = bool(torch.isfinite(torch.min(final))) and bool(torch.all(torch.isfinite(shift)))
        out = s + (shift if ok else torch.zeros_like(shift))[None, :]
    return _np(out)


def likelihood_resample(samples, synth_fn, measured, n_sig: float, gen: torch.Generator,
                        temper: float = 1.0, u0: float | None = None) -> np.ndarray:
    """Systematic importance resampling with w_i ∝ exp(temper·logL_i);
    ``temper`` < 1 flattens the weights. Unchanged when no draw has a finite
    likelihood. ``u0``: optional uniform draw in [0, 1)."""
    s = _f32(_np(samples))
    wf = synth_fn(s)
    s = s.to(wf.device)
    logl = _logl(wf, measured, n_sig)
    if not bool(torch.any(torch.isfinite(logl))):
        return np.asarray(samples)  # nothing to weight by; leave unchanged
    w = torch.exp(temper * (logl - torch.max(logl)))
    w = w / torch.sum(w)
    u0 = _uniform(gen) if u0 is None else float(u0)
    return _np(s[_systematic(w, s.shape[0], u0)])


def smoothed_resample(samples, synth_fn, measured, n_sig: float, gen: torch.Generator,
                      temper: float = 1.0, n_out: int | None = None, u0: float | None = None,
                      jitter=None) -> np.ndarray:
    """:func:`likelihood_resample` plus a Gaussian kernel jitter, Scott's
    rule on the weighted covariance with the ESS as the sample size.

    ``u0``: optional uniform draw; ``jitter``: optional (n_out, P) unit
    normal draws."""
    s = _f32(_np(samples))
    n, p = s.shape
    wf = synth_fn(s)
    s = s.to(wf.device)
    logl = _logl(wf, measured, n_sig)
    if not bool(torch.any(torch.isfinite(logl))):
        return np.asarray(samples)
    w = torch.exp(temper * (logl - torch.max(logl)))
    w = w / torch.sum(w)
    n_out = int(n_out or n)
    ess = float(1.0 / torch.sum(w**2))
    mu = torch.sum(w[:, None] * s, dim=0)
    c = s - mu[None, :]
    cov_w = (c * w[:, None]).T @ c / torch.clamp_min(1.0 - torch.sum(w**2), 1e-12)
    cov_w = cov_w + 1e-24 * torch.eye(p, device=s.device)
    h = max(ess, 2.0) ** (-1.0 / (p + 4))
    u0 = _uniform(gen) if u0 is None else float(u0)
    idx = _systematic(w, n_out, u0)
    chol, info = torch.linalg.cholesky_ex(cov_w)
    if int(info) != 0:  # not positive definite: NaN, as jnp.linalg.cholesky gives
        chol = torch.full_like(cov_w, torch.nan)
    eps = _f32(jitter, s.device) if jitter is not None else _normal(gen, (n_out, p), s.device)
    return _np(s[idx] + (h * eps) @ chol.T)


def kde_is_resample(pool, synth_fn, measured, n_sig: float, gen: torch.Generator, bounds=None,
                    n_draw: int = 16384, n_out: int = 4000, idx=None, normal=None,
                    u0: float | None = None):
    """Importance sampling with the pool's Gaussian KDE as proposal: draw
    θ ~ q̃ = (1/n)Σ N(θ_i, H), weight w = 1[bounds]·L(θ)/q̃(θ), resample.
    ``bounds``: ((lo, hi), ...) per parameter. Host float64, as in the
    reference; the forward model runs on its device.

    Returns (cloud (n_out, P), ess of the importance weights).
    ``idx``: optional (n_draw,) pool indices; ``normal``: optional
    (n_draw, P) unit normal draws; ``u0``: optional uniform draw.
    """
    pool = np.asarray(pool, np.float64)
    n, p = pool.shape
    # the reference's exponent, −2/(p+2), reproduced (Scott's rule is −2/(p+4))
    cov = np.cov(pool, rowvar=False) * n ** (-2.0 / (p + 2.0))
    cov += 1e-24 * np.eye(p)
    chol = np.linalg.cholesky(cov)
    prec = np.linalg.inv(cov)
    lognorm = -np.log(n) - 0.5 * (p * np.log(2 * np.pi) + np.log(np.linalg.det(cov)))
    if idx is None:
        idx = torch.randint(0, n, (n_draw,), generator=gen, device=gen.device)
    if normal is None:
        normal = torch.randn((n_draw, p), generator=gen, device=gen.device)
    th = pool[_np(idx)] + np.asarray(_np(normal), np.float64) @ chol.T

    def logq(x, chunk=2048):
        out = []
        for i in range(0, x.shape[0], chunk):
            d = x[i:i + chunk, None, :] - pool[None, :, :]
            m = np.einsum("mnd,de,mne->mn", d, prec, d)
            mmin = m.min(axis=1, keepdims=True)
            out.append(-0.5 * mmin[:, 0] + np.log(np.exp(-0.5 * (m - mmin)).sum(axis=1)))
        return lognorm + np.concatenate(out)

    wf = synth_fn(th)
    logl = -0.5 * _np(_sq_resid(wf, measured)) / (n_sig**2)
    logw = np.where(np.isfinite(logl), logl, -np.inf) - logq(th)
    if bounds is not None:
        for j, (lo, hi) in enumerate(bounds):
            logw = np.where((th[:, j] >= lo) & (th[:, j] <= hi), logw, -np.inf)
    if not np.isfinite(logw).any():
        return pool[:n_out].copy(), 0.0
    logw = logw - logw.max()
    w = np.exp(logw)
    w /= w.sum()
    ess = float(1.0 / np.sum(w**2))
    u0 = _uniform(gen) if u0 is None else float(u0)
    pts = (u0 + np.arange(n_out)) / n_out
    ridx = np.clip(np.searchsorted(np.cumsum(w), pts), 0, n_draw - 1)
    return th[ridx], ess


def plateau_pool(clouds: dict, scores: dict, delta: float = 0.1):
    """Pool the clouds whose score sits within ``delta`` (nats) of the
    maximum. Returns (pooled_samples, member_keys sorted ascending), or
    (None, []) when no score is finite."""
    finite = {k: v for k, v in scores.items() if k in clouds and np.isfinite(v)}
    if not finite:
        return None, []
    mx = max(finite.values())
    members = sorted(k for k, v in finite.items() if v >= mx - delta)
    pool = np.concatenate([np.asarray(clouds[k]) for k in members], axis=0)
    return pool, members


def select_final_cloud(clouds: dict, synth_fn, measured, n_sig: float, gen: torch.Generator,
                       extra: dict | None = None, delta: float = 0.1, n_out: int = 4000,
                       chunk: int = 16384, n_cap: int = 20000, bounds=None,
                       draws: dict | None = None):
    """Truth-free final-posterior selection over a candidate library: the
    per-cloud ELBO argmax, the ELBO-plateau pool, the pool of all clouds,
    their smoothed resamples (``plat_is``, ``pool_is``), the KDE importance
    resample of the pool (``kde_is``) and the caller's ``extra`` candidates,
    scored by :func:`elbo_score`. ELBO argmax, except that ``kde_is`` wins
    when within one combined standard error of it with IS ESS ≥ 100.

    Returns ``(name, cloud, info)``. ``draws``: optional dict with keys
    ``"plat_is"``/``"pool_is"`` (kwargs ``u0``, ``jitter`` of
    :func:`smoothed_resample`), ``"kde_is"`` (``idx``, ``normal``, ``u0``)
    and ``"cap_plateau"``/``"cap_pool"`` (index arrays for the n_cap cut).
    """
    draws = draws or {}

    def synth_chunked(s):
        if s.shape[0] <= chunk:
            return synth_fn(s)
        return torch.cat([synth_fn(s[i:i + chunk]) for i in range(0, s.shape[0], chunk)])

    live = {k: np.asarray(v) for k, v in clouds.items()
            if np.asarray(v)[:, 0].var() > 0 and np.asarray(v)[:, 1].var() > 0}
    cands = dict(extra or {})
    info = {}
    if live:
        per = {s: elbo_score(c, synth_chunked, measured, n_sig) for s, c in live.items()}
        argmax_step = max(per, key=per.get)
        plat, members = plateau_pool(live, per, delta=delta)
        pool = np.concatenate(list(live.values()), axis=0)

        def cap(c, name):
            # bound the pooled products: downstream KDEs are O(n·grid)
            if c.shape[0] <= n_cap:
                return c
            idx = draws.get(f"cap_{name}")
            if idx is None:
                idx = torch.randperm(c.shape[0], generator=gen, device=gen.device)[:n_cap]
            return c[_np(idx)]

        cands["argmax"] = live[argmax_step]
        if plat is not None:
            cands["plateau"] = cap(plat, "plateau")
            cands["plat_is"] = smoothed_resample(plat, synth_chunked, measured, n_sig, gen,
                                                 n_out=n_out, **draws.get("plat_is", {}))
        cands["pool"] = cap(pool, "pool")
        cands["pool_is"] = smoothed_resample(pool, synth_chunked, measured, n_sig, gen,
                                             n_out=n_out, **draws.get("pool_is", {}))
        cands["kde_is"], kde_ess = kde_is_resample(cands["pool"], synth_chunked, measured, n_sig,
                                                   gen, bounds=bounds, n_out=n_out,
                                                   **draws.get("kde_is", {}))
        info.update({
            "argmax_step": argmax_step,
            "plateau_members": members,
            "pool_ess": effective_sample_size(pool, synth_chunked, measured, n_sig),
            "kde_ess": kde_ess,
        })
    if not cands:
        return None, None, info
    scores, ses = {}, {}
    for name, c in cands.items():
        c = np.asarray(c)
        if c[:, 0].var() <= 0 or c[:, 1].var() <= 0:
            scores[name] = float("-inf")  # collapsed candidate: unselectable
            ses[name] = float("inf")
            continue
        scores[name], ses[name] = elbo_score(c, synth_chunked, measured, n_sig, return_se=True)
    info["scores"] = scores
    info["score_ses"] = ses
    info["candidates"] = cands
    best = max(scores, key=scores.get)
    # SE-aware tie-break (the reference's rule): kde_is is the only unbiased
    # importance-sampling candidate, preferred within one combined SE
    kde_ess = info.get("kde_ess", 0.0)
    if (best != "kde_is" and "kde_is" in scores
            and np.isfinite(scores["kde_is"]) and kde_ess >= 100.0):
        tol = np.sqrt(ses[best] ** 2 + ses["kde_is"] ** 2)
        if np.isfinite(tol) and scores["kde_is"] >= scores[best] - tol:
            info["tiebreak"] = {"over": best, "tol": float(tol),
                                "gap": float(scores[best] - scores["kde_is"])}
            best = "kde_is"
    return best, np.asarray(cands[best]), info


def elbo_score(samples, synth_fn, measured, n_sig: float, entropy: str = "gauss",
               return_se: bool = False):
    """ELBO of the cloud against the data-only posterior: E_q[logL] + H(q),
    H from a Gaussian fit (``"gauss"``) or the Kozachenko–Leonenko k-NN
    estimator (``"knn"``). Non-finite draws are charged the worst finite
    logL − 100; −inf when no draw is finite. ``return_se`` adds the Monte
    Carlo standard error of E_q[logL], std(logL)/√n."""
    s = _f32(_np(samples))
    n, p = s.shape
    wf = synth_fn(s)
    s = s.to(wf.device)
    logl = -0.5 * _sq_resid(wf, measured) / (n_sig**2)
    finite = torch.isfinite(logl)
    if not bool(torch.any(finite)):
        return (float("-inf"), float("inf")) if return_se else float("-inf")
    floor = torch.min(torch.where(finite, logl, torch.full_like(logl, torch.inf))) - 100.0
    logl_f = torch.where(finite, logl, floor)
    mean_logl = torch.mean(logl_f)
    if entropy == "knn":
        from scipy.special import digamma, gammaln

        k = min(4, n - 1)
        x = np.asarray(_np(s), np.float64)
        d2 = np.sum((x[:, None, :] - x[None, :, :]) ** 2, axis=-1)
        np.fill_diagonal(d2, np.inf)
        eps = np.sqrt(np.partition(d2, k - 1, axis=1)[:, k - 1])
        eps = np.maximum(eps, 1e-300)  # duplicate points (resampled clouds)
        log_vp = (p / 2.0) * np.log(np.pi) - gammaln(p / 2.0 + 1.0)
        h = digamma(n) - digamma(k) + log_vp + (p / n) * np.sum(np.log(eps))
    else:
        cov = torch.cov(s.T) + 1e-24 * torch.eye(p, device=s.device)
        sign, logdet = torch.linalg.slogdet(2.0 * np.pi * np.e * cov)
        h = 0.5 * float(logdet) if float(sign) > 0 else float("-inf")
    out = float(mean_logl) + h
    if not np.isfinite(out):
        out = float("-inf")
    if return_se:
        se = float(torch.std(logl_f, correction=0) / np.sqrt(n))
        return out, (se if np.isfinite(out) else float("inf"))
    return out


def select_route(samples, synth_fn, cnn_fn, measured, n_sig: float, gen: torch.Generator,
                 temper: float = 1.0, entropy: str = "gauss", draws: dict | None = None):
    """Truth-free calibration-route selection by ELBO over raw, bootcal,
    mlrc, mlrc_bootcal and (``temper`` > 0) reweight and mlrc_reweight.
    Returns ``(best_name, best_cloud, scores)``. ``draws``: optional dict,
    per route, of the draws its function takes (``"bootcal"``: ``noise``;
    ``"mlrc"``/``"mlrc_bootcal"``: ``jitter``; ``"reweight"``/
    ``"mlrc_reweight"``: ``u0``)."""
    draws = draws or {}
    candidates = {"raw": samples}
    candidates["bootcal"] = bootstrap_calibrate(samples, synth_fn, cnn_fn, gen, n_sig,
                                                **draws.get("bootcal", {}))
    candidates["mlrc"] = ml_recenter(samples, synth_fn, measured, gen, **draws.get("mlrc", {}))
    candidates["mlrc_bootcal"] = ml_recenter(candidates["bootcal"], synth_fn, measured, gen,
                                             **draws.get("mlrc_bootcal", {}))
    if temper > 0:
        candidates["reweight"] = likelihood_resample(samples, synth_fn, measured, n_sig, gen,
                                                     temper=temper, **draws.get("reweight", {}))
        candidates["mlrc_reweight"] = likelihood_resample(
            candidates["mlrc"], synth_fn, measured, n_sig, gen, temper=temper,
            **draws.get("mlrc_reweight", {}))
    scores = {name: elbo_score(c, synth_fn, measured, n_sig, entropy=entropy)
              for name, c in candidates.items()}
    best = max(scores, key=scores.get)
    return best, np.asarray(candidates[best]), scores


def effective_sample_size(samples, synth_fn, measured, n_sig: float,
                          temper: float = 1.0) -> float:
    """ESS of the likelihood weights, the proposal-adequacy diagnostic
    (small ESS ⇒ the cloud under-covers the posterior); 0 when no draw has
    a finite likelihood."""
    wf = synth_fn(_f32(_np(samples)))
    logl = _logl(wf, measured, n_sig)
    if not bool(torch.any(torch.isfinite(logl))):
        return 0.0
    w = torch.exp(temper * (logl - torch.max(logl)))
    w = w / torch.sum(w)
    return float(1.0 / torch.sum(w**2))
