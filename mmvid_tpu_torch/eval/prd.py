"""Precision-Recall for Distributions (PRD), Sajjadi et al. 2018
(arXiv:1806.00035).

The port's copy of ``mmvid_tpu/eval/prd.py``: the PRD curve over an
equiangular slope grid, k-means binning of the embeddings, and the (F_8,
F_1/8) summary pair.  The JAX package bins with sklearn's
``MiniBatchKMeans(n_init=10)``, unseeded; the port needs no sklearn: its
:func:`kmeans` is that algorithm at its defaults written in numpy, drawn
from an explicit ``numpy.random.Generator``.  On well-separated clusters
both find the same bins; elsewhere each run of either is one draw of a
random binning.
"""

from __future__ import annotations

import numpy as np


def compute_prd(eval_dist, ref_dist, num_angles: int = 1001,
                epsilon: float = 1e-10):
    """PRD curve of a discrete eval distribution against a reference.

    For each slope lambda = tan(theta): precision(lambda) =
    sum_i min(lambda * ref_i, eval_i), recall = precision / lambda.
    """
    if not 0 < epsilon <= 0.1:
        raise ValueError(f'epsilon must be in (0, 0.1] but is {epsilon}.')
    if not 3 <= num_angles <= 1e6:
        raise ValueError(
            f'num_angles must be in [3, 1e6] but is {num_angles}.')
    eval_dist = np.asarray(eval_dist, np.float64)
    ref_dist = np.asarray(ref_dist, np.float64)

    angles = np.linspace(epsilon, np.pi / 2 - epsilon, num=num_angles)
    slopes = np.tan(angles)
    precision = np.minimum(ref_dist[None, :] * slopes[:, None],
                           eval_dist[None, :]).sum(axis=1)
    recall = precision / slopes
    if max(precision.max(), recall.max()) > 1.001:
        raise ValueError('Detected value > 1.001, this should not happen.')
    return np.clip(precision, 0, 1), np.clip(recall, 0, 1)


def _sq_dists(data, centers):
    return np.maximum(np.sum(data ** 2, 1)[:, None] - 2.0 * data @ centers.T
                      + np.sum(centers ** 2, 1)[None, :], 0.0)


def _kmeans_pp(data, k, rng):
    """Greedy k-means++ starts (sklearn's ``_kmeans_plusplus``: 2 + log k
    candidates a centre, the one that lowers the potential most)."""
    n = len(data)
    trials = 2 + int(np.log(k))
    centers = np.empty((k, data.shape[1]))
    centers[0] = data[rng.integers(n)]
    closest = _sq_dists(data, centers[:1])[:, 0]
    pot = closest.sum()
    for c in range(1, k):
        ids = np.searchsorted(np.cumsum(closest), rng.uniform(size=trials)
                              * pot)
        ids = np.minimum(ids, n - 1)
        d2 = np.minimum(closest[None, :], _sq_dists(data[ids], data))
        pots = d2.sum(1)
        best = pots.argmin()
        closest, pot = d2[best], pots[best]
        centers[c] = data[ids[best]]
    return centers


def kmeans(data, k: int, rng: np.random.Generator, n_init: int = 10,
           batch_size: int = 1024, max_iter: int = 100,
           max_no_improvement: int = 10,
           reassignment_ratio: float = 0.01) -> np.ndarray:
    """Cluster labels [N] of ``data`` [N, D]: sklearn's ``MiniBatchKMeans``
    algorithm at its defaults, as the reference and the JAX package call
    it (``n_init`` greedy k-means++ starts on random subsets, the best by
    inertia on a validation subset; mini-batches drawn with replacement,
    each centre moving to the running mean of its points; centres with
    few points re-seeded every 10 k points; a stop after
    ``max_no_improvement`` steps without a lower smoothed inertia)."""
    data = np.asarray(data, np.float64)
    n = len(data)
    bs = min(batch_size, n)
    init_size = 3 * bs if 3 * bs >= k else 3 * k
    valid = data[rng.integers(0, n, init_size)]
    best, best_inertia = None, np.inf
    for _ in range(n_init):
        sub = data[rng.integers(0, n, init_size)] if init_size < n else data
        centers = _kmeans_pp(sub, k, rng)
        inertia = _sq_dists(valid, centers).min(1).sum()
        if inertia < best_inertia:
            best, best_inertia = centers, inertia
    centers = best
    counts = np.zeros(k)
    ewa = ewa_min = None
    no_improvement = since_reassign = 0
    for step in range(1, max_iter * n // bs + 1):
        batch = data[rng.integers(0, n, bs)]
        since_reassign += bs
        reassign = (counts == 0).any() or since_reassign >= 10 * k
        if reassign:
            since_reassign = 0
        d2 = _sq_dists(batch, centers)
        labels = d2.argmin(1)
        batch_inertia = d2[np.arange(bs), labels].sum()
        w = np.bincount(labels, minlength=k).astype(np.float64)
        sums = np.zeros_like(centers)
        np.add.at(sums, labels, batch)
        hit = w > 0
        new = centers.copy()
        new[hit] = ((centers[hit] * counts[hit, None] + sums[hit])
                    / (counts[hit] + w[hit])[:, None])
        counts += w
        if reassign and reassignment_ratio > 0:
            low = counts < reassignment_ratio * counts.max()
            if low.sum() > 0.5 * bs:
                low[np.argsort(counts)[int(0.5 * bs):]] = False
            if low.any():
                new[low] = batch[rng.choice(bs, low.sum(), replace=False)]
                counts[low] = counts[~low].min()
        centers = new
        if step == 1:
            continue
        mean_inertia = batch_inertia / bs
        alpha = min(bs * 2.0 / (n + 1), 1.0)
        ewa = (mean_inertia if ewa is None
               else ewa * (1 - alpha) + mean_inertia * alpha)
        if ewa_min is None or ewa < ewa_min:
            no_improvement, ewa_min = 0, ewa
        else:
            no_improvement += 1
        if no_improvement >= max_no_improvement:
            break
    return _sq_dists(data, centers).argmin(1)


def _cluster_into_bins(eval_data, ref_data, num_clusters: int, rng):
    """k-means over the union; per-cluster densities."""
    data = np.vstack([eval_data, ref_data])
    labels = kmeans(data, num_clusters, rng)
    eval_labels = labels[:len(eval_data)]
    ref_labels = labels[len(eval_data):]
    eval_bins = np.histogram(eval_labels, bins=num_clusters,
                             range=[0, num_clusters], density=True)[0]
    ref_bins = np.histogram(ref_labels, bins=num_clusters,
                            range=[0, num_clusters], density=True)[0]
    return eval_bins, ref_bins


def compute_prd_from_embedding(eval_data, ref_data, num_clusters: int = 20,
                               num_angles: int = 1001, num_runs: int = 10,
                               enforce_balance: bool = True,
                               rng: np.random.Generator | None = None):
    """Average PRD curve over ``num_runs`` k-means clusterings; ``rng``
    draws the k-means starts (``numpy.random.default_rng(0)`` if None)."""
    eval_data = np.asarray(eval_data, np.float64)
    ref_data = np.asarray(ref_data, np.float64)
    if enforce_balance and len(eval_data) != len(ref_data):
        raise ValueError(
            'The number of points in eval_data %d should be equal to the '
            'number of points in ref_data %d. To disable this behavior, '
            'set enforce_balance to False (not recommended).'
            % (len(eval_data), len(ref_data)))
    rng = np.random.default_rng(0) if rng is None else rng

    precisions, recalls = [], []
    for _ in range(num_runs):
        eval_dist, ref_dist = _cluster_into_bins(eval_data, ref_data,
                                                 num_clusters, rng)
        p, r = compute_prd(eval_dist, ref_dist, num_angles)
        precisions.append(p)
        recalls.append(r)
    return (np.mean(precisions, axis=0), np.mean(recalls, axis=0))


def _f_beta(precision, recall, beta):
    b2 = beta ** 2
    denom = b2 * precision + recall
    return np.where(denom > 0,
                    (1 + b2) * precision * recall / np.maximum(denom, 1e-30),
                    0.0)


def prd_to_max_f_beta_pair(precision, recall, beta: float = 8):
    """(max F_beta, max F_{1/beta}) summary of a PRD curve."""
    precision = np.asarray(precision)
    recall = np.asarray(recall)
    if not ((precision >= 0).all() and (precision <= 1).all()):
        raise ValueError('All values in precision must be in [0, 1].')
    if not ((recall >= 0).all() and (recall <= 1).all()):
        raise ValueError('All values in recall must be in [0, 1].')
    if beta <= 0:
        raise ValueError(f'Given parameter beta {beta} must be positive.')
    return (float(np.max(_f_beta(precision, recall, beta))),
            float(np.max(_f_beta(precision, recall, 1.0 / beta))))


def plot(precision_recall_pairs, labels=None, out_path=None,
         legend_loc='lower left', dpi=300):
    """PRD curve plot (reference prd_score.py:277-327); needs
    matplotlib."""
    if labels is not None and len(labels) != len(precision_recall_pairs):
        raise ValueError(
            'Length of labels %d must be identical to length of '
            'precision_recall_pairs %d.'
            % (len(labels), len(precision_recall_pairs)))
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError('prd.plot needs matplotlib, which is not '
                           'installed; the scores need no plot') from e
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(3.5, 3.5), dpi=dpi)
    plot_handle = fig.add_subplot(111)
    plot_handle.tick_params(axis='both', which='major', labelsize=12)
    for i, (precision, recall) in enumerate(precision_recall_pairs):
        label = labels[i] if labels is not None else None
        plt.plot(recall, precision, label=label, alpha=0.5, linewidth=3)
    if labels is not None:
        plt.legend(loc=legend_loc)
    plt.xlim([0, 1])
    plt.ylim([0, 1])
    plt.xlabel('Recall', fontsize=12)
    plt.ylabel('Precision', fontsize=12)
    plt.tight_layout()
    if out_path is None:
        return fig
    plt.savefig(out_path, bbox_inches='tight', dpi=dpi)
    plt.close()
    return None
