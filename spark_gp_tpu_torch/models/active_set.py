"""Active-set (inducing point) providers.

The SPI takes the full training rows (host numpy), the kernel and the
optimal hyperparameters, and returns the ``[m, p]`` active points.

* :data:`RandomActiveSetProvider` -- a uniform sample of training rows;
* :class:`KMeansActiveSetProvider` -- k-means centroids: k-means++
  seeding, then Lloyd steps, on the fit's device in float64;
* :class:`GreedilyOptimizingActiveSetProvider` -- Seeger et al. 2003 fast
  forward selection (``greedy.py``), on the fit's device in its working
  dtype.

Each provider also selects straight off a rank-local expert stack
(``from_stack(m, data, kernel, theta, seed, mesh)``, the entry
``fit_distributed`` and the mesh fits use where no rank holds every
row): the same active set on every rank, from collectives over the
``mesh`` (``parallel/mesh.py``; ``None`` for a stack that is whole
here).  ``data.y`` carries the targets (labels, or a classifier's latent
modes).
"""

from __future__ import annotations

import numpy as np
import torch

from spark_gp_tpu_torch.ops.distance import sq_dist


class ActiveSetProvider:
    """SPI: ``(active_set_size, x, y, kernel, theta_opt, seed) -> [m, p]``.

    ``uses_fit_outputs`` tells the fit whether the provider reads the
    fitted hyperparameters and targets at all."""

    uses_fit_outputs = True

    def __call__(self, active_set_size, x, y, kernel, theta_opt, seed):
        raise NotImplementedError

    def from_stack(self, active_set_size, data, kernel, theta, seed, mesh):
        """``[m, p]`` active points off a rank-local stack.  A provider
        without its own implementation falls back, with a warning, to the
        uniform draw."""
        import warnings

        from spark_gp_tpu_torch.parallel.distributed import sample_active_from_stack

        warnings.warn(
            f"{type(self).__name__} has no sharded-stack implementation; "
            "falling back to uniform sampling for fit_distributed.  "
            "Implement from_stack(...) to override.",
            stacklevel=2,
        )
        return sample_active_from_stack(data, active_set_size, seed, mesh)


class _RandomActiveSetProvider(ActiveSetProvider):
    """Uniform sample of m training rows without replacement, from numpy's
    ``default_rng(seed)`` -- the same rows the JAX package picks."""

    uses_fit_outputs = False

    def __call__(self, active_set_size, x, y, kernel, theta_opt, seed):
        rng = np.random.default_rng(seed)
        n = x.shape[0]
        idx = rng.choice(n, size=min(active_set_size, n), replace=False)
        return np.asarray(x)[idx]

    def from_stack(self, active_set_size, data, kernel, theta, seed, mesh):
        """The uniform draw over the stack's real rows
        (``parallel/distributed.sample_active_from_stack``)."""
        from spark_gp_tpu_torch.parallel.distributed import sample_active_from_stack

        return sample_active_from_stack(data, active_set_size, seed, mesh)


RandomActiveSetProvider = _RandomActiveSetProvider()


class KMeansActiveSetProvider(ActiveSetProvider):
    """K-means centroids as the active set: k-means++ D^2 seeding, then
    ``max_iter`` Lloyd steps (the JAX package's, whose default is the
    reference's 20), in float64 on ``device`` -- the fit passes its own.

    The draws come from a ``torch.Generator`` on that device seeded with
    ``seed``: the same rows for the same seed and device, but not the JAX
    package's rows, whose PRNG cannot be reproduced here (nor the same
    rows on the CPU and the card).  A Lloyd step keeps an empty cluster's
    previous centroid and breaks ties of the distance as ``torch.argmin``
    does: the lowest centroid index wins."""

    uses_fit_outputs = False

    def __init__(self, max_iter: int = 20):
        self.max_iter = max_iter

    def __call__(self, active_set_size, x, y, kernel, theta_opt, seed,
                 device="cpu"):
        xt = torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)
        k = min(active_set_size, xt.shape[0])
        gen = torch.Generator(device=xt.device).manual_seed(int(seed))
        centroids = _lloyd(xt, _kmeanspp_init(gen, xt, k), self.max_iter)
        return centroids.cpu().numpy()

    def from_stack(self, active_set_size, data, kernel, theta, seed, mesh):
        """Sharded Lloyd over the rank-local stack (the JAX package's):
        k-means++ seeds from a uniform subsample of ``max(4 m, 4096)`` real
        rows (``sample_active_from_stack``, the same rows on every rank),
        then ``max_iter`` Lloyd steps in float64 on the stack's device, each
        rank's per-cluster sums and counts summed by one all-reduce a
        step, so every rank holds the same centroids."""
        from spark_gp_tpu_torch.parallel.distributed import sample_active_from_stack

        sub = sample_active_from_stack(data, max(4 * active_set_size, 4096), seed, mesh)
        device = data.x.device
        xs = torch.as_tensor(sub, dtype=torch.float64, device=device)
        k = min(active_set_size, xs.shape[0])
        gen = torch.Generator(device=device).manual_seed(int(seed))
        p = data.x.shape[-1]
        centroids = _lloyd(data.x.reshape(-1, p).to(torch.float64),
                           _kmeanspp_init(gen, xs, k), self.max_iter,
                           mask=data.mask.reshape(-1).to(torch.float64), mesh=mesh)
        return centroids.cpu().numpy()


class GreedilyOptimizingActiveSetProvider(ActiveSetProvider):
    """Seeger et al. 2003 fast forward selection (ASP.scala:59-136) on
    ``device`` (the fit passes its own; ``None`` means ``cuda``): the same
    rows as the JAX package's provider in float64.  ``kernel`` is the
    noise-augmented model kernel the fit hands every provider."""

    def __call__(self, active_set_size, x, y, kernel, theta_opt, seed, device=None):
        from spark_gp_tpu_torch.models.greedy import greedy_active_set

        return greedy_active_set(active_set_size, x, y, kernel, theta_opt, seed, device)

    def from_stack(self, active_set_size, data, kernel, theta, seed, mesh):
        """The sharded Seeger rounds (``greedy.greedy_active_set_from_stack``)."""
        from spark_gp_tpu_torch.models.greedy import greedy_active_set_from_stack

        return greedy_active_set_from_stack(active_set_size, data, kernel, theta, seed, mesh)


def _kmeanspp_init(gen: torch.Generator, x, k: int):
    """k-means++ seeding (Arthur and Vassilvitskii 2007): each next seed is
    drawn with weight its squared distance to the nearest seed so far, so
    a chosen row (weight 0) and its duplicates are never drawn again while
    any spread remains; when none does, the draw is uniform."""
    n = x.shape[0]
    idx = torch.randint(n, (1,), generator=gen, device=x.device)
    centroids = [x[idx]]
    min_d2 = torch.sum((x - x[idx]) ** 2, dim=1)
    for _ in range(1, k):
        weights = torch.where(min_d2.max() > 0, min_d2, torch.ones_like(min_d2))
        idx = torch.multinomial(weights, 1, generator=gen)
        centroids.append(x[idx])
        min_d2 = torch.minimum(min_d2, torch.sum((x - x[idx]) ** 2, dim=1))
    return torch.cat(centroids)


def _lloyd(x, centroids, max_iter: int, mask=None, mesh=None):
    """``max_iter`` Lloyd steps from ``centroids [k, p]`` over ``x [n, p]``:
    assignment by the squared distance, then each centroid the mean of its
    points (a one-hot matmul); an empty cluster keeps its centroid.
    ``mask [n]`` keeps padded rows out of the sums and counts; with
    ``mesh`` the rows are this rank's and one all-reduce a step sums the
    ranks' ``[k, p + 1]`` sums and counts.  The
    two contractions ride the precision lanes as the JAX package's do: the
    distances the gram stage (``ops/distance.sq_dist``), the one-hot sums
    the linalg stage, which the port runs in IEEE arithmetic on every lane
    (``ops/precision.py``).  The provider runs in float64, where every
    lane is the strict one."""
    k = centroids.shape[0]
    for _ in range(max_iter):
        assign = torch.argmin(sq_dist(x, centroids), dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(x.dtype)  # [n, k]
        if mask is not None:
            onehot = onehot * mask[:, None]
        counts = onehot.sum(dim=0)[:, None]
        sums = onehot.mT @ x
        if mesh is not None:
            fused = mesh.all_reduce(torch.cat([sums, counts], dim=1))
            sums, counts = fused[:, :-1], fused[:, -1:]
        centroids = torch.where(counts > 0, sums / torch.clamp_min(counts, 1.0), centroids)
    return centroids
