"""Surrogate model families (paper Table I): Mean, Table (nearest-neighbor),
Linear, GBDT (histogram boosting of complete trees), MLP (100, 50).

Port of ``repro.core.models``. Each ``fit(xtr, ytr, xva, yva)`` takes host
arrays and computes what the reference's does; ``predict(x)`` returns a
host array and ``predict_t(x)`` the device tensor behind it.

The statistics that decide everything downstream stay on the host in
numpy, copied as they are: :class:`Standardizer`, the table's row
subsample, the linear model's minimum-norm least-squares solve (float64
``lstsq``; its design matrix is rank-deficient wherever a feature column
is constant), the GBDT's quantile bin edges and row subsamples, and the
MLP's epoch permutations. The heavy loops run on the model's device
(``cuda`` unless given): the GBDT's per-level histograms, split search and
descent, the MLP's Adam steps, the table's distances, and every
prediction — the MLP's through ``kernels.mlp_surrogate`` (its plain
version on CPU tensors).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.mlp_surrogate import mlp_surrogate


# --- standardization -----------------------------------------------------------

@dataclasses.dataclass
class Standardizer:
    mu: np.ndarray
    sd: np.ndarray

    @staticmethod
    def fit(x: np.ndarray) -> "Standardizer":
        mu = x.mean(axis=0)
        sd = x.std(axis=0)
        sd = np.where(sd < 1e-12, 1.0, sd)
        return Standardizer(mu.astype(np.float32), sd.astype(np.float32))

    def apply(self, x):
        return (x - self.mu) / self.sd

    def apply_t(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`apply` on a tensor, on its device."""
        return (x - torch.as_tensor(self.mu, device=x.device)) \
            / torch.as_tensor(self.sd, device=x.device)


class SurrogateModel:
    """A model family: host-array ``fit``, device ``predict_t``."""

    name: str = "base"
    train_time: float = 0.0

    def __init__(self, device=None):
        self.device = device

    def _dev(self) -> torch.device:
        return ops.resolve_device(self.device)

    def _rows(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32) if not isinstance(
            x, torch.Tensor) else x, dtype=torch.float32, device=self._dev())

    def fit(self, xtr, ytr, xva, yva):  # pragma: no cover - interface
        raise NotImplementedError

    def predict_t(self, x) -> torch.Tensor:  # pragma: no cover - interface
        raise NotImplementedError

    def predict(self, x) -> np.ndarray:
        """Predictions for host rows ``x`` (N, F), as a host array."""
        return self.predict_t(x).cpu().numpy()


# --- mean ------------------------------------------------------------------------

class MeanModel(SurrogateModel):
    name = "mean"

    def fit(self, xtr, ytr, xva, yva):
        t0 = time.time()
        self.mu = float(np.mean(ytr))
        self.train_time = time.time() - t0
        return self

    def predict_t(self, x):
        return torch.full((x.shape[0],), self.mu, dtype=torch.float32,
                          device=self._dev())


# --- table (1-NN) -----------------------------------------------------------------

class TableModel(SurrogateModel):
    """Nearest-neighbor estimator over a 20,000-row subsample of the
    standardized training rows; the distances run on the device, a block
    of queries at a time."""

    name = "table"
    # distance-matrix entries per block of queries
    BLOCK_ENTRIES = 1 << 27

    def __init__(self, max_rows: int = 20000, device=None):
        super().__init__(device)
        self.max_rows = max_rows

    def fit(self, xtr, ytr, xva, yva):
        t0 = time.time()
        n = min(len(ytr), self.max_rows)
        idx = np.random.default_rng(0).permutation(len(ytr))[:n]
        self.sx = Standardizer.fit(xtr)
        self.tx = self.sx.apply(xtr[idx]).astype(np.float32)
        self.ty = ytr[idx].astype(np.float32)
        self.train_time = time.time() - t0
        return self

    def predict_t(self, x):
        dev = self._dev()
        xs = self.sx.apply_t(self._rows(x))
        tx = torch.as_tensor(self.tx, device=dev)
        ty = torch.as_tensor(self.ty, device=dev)
        t_sq = (tx * tx).sum(-1)
        step = max(1, self.BLOCK_ENTRIES // max(tx.shape[0], 1))
        out = torch.empty((xs.shape[0],), dtype=torch.float32, device=dev)
        for i in range(0, xs.shape[0], step):
            # |a-b|^2 = |a|^2 - 2ab + |b|^2 (argmin ignores |a|^2)
            d = t_sq[None, :] - 2.0 * (xs[i:i + step] @ tx.T)
            out[i:i + step] = ty[torch.argmin(d, dim=1)]
        return out


# --- linear ------------------------------------------------------------------------

class LinearModel(SurrogateModel):
    name = "linear"

    def fit(self, xtr, ytr, xva, yva):
        t0 = time.time()
        self.sx = Standardizer.fit(xtr)
        a = np.concatenate([self.sx.apply(xtr),
                            np.ones((len(ytr), 1), np.float32)], axis=1)
        # minimum-norm solution (gelsd): a constant column standardizes to
        # zeros and leaves the system rank-deficient
        w, *_ = np.linalg.lstsq(a.astype(np.float64), ytr.astype(np.float64),
                                rcond=None)
        self.w = w.astype(np.float32)
        self.train_time = time.time() - t0
        return self

    def predict_t(self, x):
        xs = self.sx.apply_t(self._rows(x))
        w = torch.as_tensor(self.w, device=xs.device)
        a = torch.cat([xs, torch.ones_like(xs[:, :1])], dim=1)
        return a @ w


# --- GBDT --------------------------------------------------------------------------

class GBDTModel(SurrogateModel):
    """Histogram gradient-boosted complete trees (CatBoost stand-in).

    Per level, the (node, feature, bin) histograms of residuals and counts
    are float64 scatter-adds on the device, the split search (cumulative
    sums, gains, masked argmax, the ``ok`` test) and the level's
    (feature, threshold) writes are tensor operations, and the rows
    descend by a gather. The validation MSE after each tree stays on the
    device; the trees kept (``mse < best - 1e-12``) are decided once, after
    the last tree. Each histogram cell and each bin's cumulative sum adds
    in numpy's order (:func:`_row_order_sums`, a sequential scan), so
    gains that tie in the reference (two features cutting the same rows)
    tie here too and the first feature wins, on the card as on the CPU."""

    name = "gbdt"

    def __init__(self, n_trees=80, max_depth=8, lr=0.12, n_bins=256,
                 subsample=0.7, min_leaf=8, l2=1.0, seed=0, device=None):
        super().__init__(device)
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.lr = lr
        self.n_bins = n_bins
        self.subsample = subsample
        self.min_leaf = min_leaf
        self.l2 = l2
        self.seed = seed

    # binning ---------------------------------------------------------------
    def _fit_bins(self, x):
        qs = np.linspace(0, 1, self.n_bins + 1)[1:-1]
        self.edges = np.quantile(x, qs, axis=0).astype(np.float32)  # (B-1, F)

    def fit(self, xtr, ytr, xva, yva):
        t0 = time.time()
        dev = self._dev()
        rng = np.random.default_rng(self.seed)
        x_np = np.asarray(xtr, np.float32)
        y_np = np.asarray(ytr, np.float64)
        n, f = x_np.shape
        b = self.n_bins
        self._fit_bins(x_np)
        self.base = float(np.mean(y_np))
        if self.subsample < 1.0:
            # one rng.random(n) per tree, as the reference draws them
            masks = rng.random((self.n_trees, n)) < self.subsample
        else:
            masks = np.ones((self.n_trees, n), bool)

        x = torch.as_tensor(x_np, device=dev)
        y = torch.as_tensor(y_np, device=dev)
        edges = torch.as_tensor(self.edges, device=dev)
        bins = torch.searchsorted(edges.T.contiguous(), x.T.contiguous(),
                                  right=True).T                    # (n, F)
        masks_t = torch.as_tensor(masks, device=dev)
        xva_t = torch.as_tensor(np.asarray(xva, np.float32), device=dev)
        yva_t = torch.as_tensor(np.asarray(yva), device=dev)
        n_nodes = 2 ** self.max_depth - 1          # internal nodes
        n_leaves = 2 ** self.max_depth
        feat = torch.zeros((self.n_trees, n_nodes), dtype=torch.long,
                           device=dev)
        thr = torch.full((self.n_trees, n_nodes), float("inf"),
                         dtype=torch.float32, device=dev)
        leaf = torch.zeros((self.n_trees, n_leaves), dtype=torch.float32,
                           device=dev)
        pred = torch.full((n,), self.base, dtype=torch.float64, device=dev)
        va_pred = torch.full((xva_t.shape[0],), self.base,
                             dtype=torch.float64, device=dev)
        va_mse = torch.empty((self.n_trees,), dtype=torch.float64,
                             device=dev)
        f_ix = torch.arange(f, device=dev)
        neg_inf = torch.tensor(-np.inf, dtype=torch.float64, device=dev)

        for t in range(self.n_trees):
            g = y - pred                                         # residuals
            mask = masks_t[t]
            gm = g[mask]
            g_one = torch.stack([gm, torch.ones_like(gm)], 1)   # (sum, count)
            g_rows = g_one.repeat_interleave(f, dim=0)
            bm = bins[mask]
            node = torch.zeros(n, dtype=torch.long, device=dev)
            for d in range(self.max_depth):
                lo = 2 ** d - 1
                n_level = 2 ** d
                rel = node[mask] - lo
                # cells (node, bin, feature): the scan over bins then runs
                # along a non-innermost axis, one sequential sum a column,
                # as numpy's cumsum
                flat = ((rel[:, None] * b + bm) * f + f_ix[None, :]).reshape(-1)
                csum = _row_order_sums(flat, g_rows, n_level * b * f).view(
                    n_level, b, f, 2).cumsum(1)
                gc, cc = csum[..., 0], csum[..., 1]
                g_tot = gc[:, -1:]
                c_tot = cc[:, -1:]
                gr, cr = g_tot - gc, c_tot - cc
                gain = (gc ** 2 / (cc + self.l2) + gr ** 2 / (cr + self.l2)
                        - g_tot ** 2 / (c_tot + self.l2))
                gain = torch.where((cc < self.min_leaf) | (cr < self.min_leaf),
                                   neg_inf, gain)
                # the last bin can't split; argmax takes the first maximum
                # in the reference's (node, feature, bin) order
                gain = gain[:, :-1].transpose(1, 2).reshape(n_level, -1)
                best = gain.argmax(dim=1)
                bf = best // (b - 1)
                bb = best % (b - 1)
                ok = gain.gather(1, best[:, None])[:, 0] > 1e-12
                # thresholds from bin edges; dead nodes stay (f=0, thr=inf)
                feat[t, lo:lo + n_level] = torch.where(ok, bf, 0)
                thr[t, lo:lo + n_level] = torch.where(
                    ok, edges[bb.clamp_max(b - 2), bf], float("inf"))
                # descend (x <= thr -> left)
                nf = feat[t][node]
                nt = thr[t][node]
                go_right = x.gather(1, nf[:, None])[:, 0] > nt
                node = 2 * node + 1 + go_right.long()
            leaf_idx = node - n_nodes
            sums = _row_order_sums(leaf_idx[mask], g_one, n_leaves)
            vals = self.lr * sums[:, 0] / (sums[:, 1] + self.l2)
            leaf[t] = vals.float()
            pred = pred + vals[leaf_idx]
            # early stopping on validation: the MSE after each tree
            va_pred = va_pred + _walk(feat[t:t + 1], thr[t:t + 1],
                                      leaf[t:t + 1], xva_t,
                                      self.max_depth)[:, 0]
            va_mse[t] = ((va_pred - yva_t) ** 2).mean()

        best_va = np.inf
        self._kept = self.n_trees
        for t, mse in enumerate(va_mse.cpu().numpy().tolist()):
            if mse < best_va - 1e-12:
                best_va = mse
                self._kept = t + 1
        k = self._kept
        self.feat = feat[:k].int().cpu().numpy()
        self.thr = thr[:k].cpu().numpy()
        self.leaf = leaf[:k].cpu().numpy()
        self.train_time = time.time() - t0
        return self

    def predict_t(self, x):
        """base, plus each tree in float32, one tree at a time (the
        reference's fit-time order; the ``Surrogate`` sums the trees in one
        reduction)."""
        dev = self._dev()
        x = self._rows(x)
        per_tree = _walk(torch.as_tensor(self.feat, device=dev).long(),
                         torch.as_tensor(self.thr, device=dev),
                         torch.as_tensor(self.leaf, device=dev), x,
                         self.max_depth)
        out = torch.full((x.shape[0],), self.base, dtype=torch.float32,
                         device=dev)
        for t in range(per_tree.shape[1]):
            out = out + per_tree[:, t]
        return out


def _row_order_sums(index, values, size):
    """``out[c] = sum of values[i] over index[i] == c``, (size, k) float64,
    each cell summed in row order from zero, as numpy's ``add.at``: the
    accumulating ``index_put_`` sorts the indices stably and sums each
    cell's run in order on the card (serially on the CPU), where
    ``index_add_``'s atomics on the card would sum in any order."""
    out = values.new_zeros((size, values.shape[1]))
    return out.index_put_((index,), values, accumulate=True)


def _walk(feat, thr, leaf, x, max_depth):
    """Leaf value of every tree for every row: (N, trees)."""
    n_t = feat.shape[0]
    tree_ix = torch.arange(n_t, device=x.device)[None, :]
    node = torch.zeros((x.shape[0], n_t), dtype=torch.long, device=x.device)
    for _ in range(max_depth):
        nf = feat[tree_ix, node]
        th = thr[tree_ix, node]
        node = 2 * node + 1 + (x.gather(1, nf) > th).long()
    return leaf[tree_ix, node - (2 ** max_depth - 1)]


# --- MLP ---------------------------------------------------------------------------

class MLPModel(SurrogateModel):
    """MLP(100, 50) in fp32 on the device: He-normal init from a
    ``torch.Generator``, ReLU, full batches of 1,024 (the last partial
    batch dropped), MSE plus ``l2 * sum |w|^2`` in the loss, Adam written
    out as the reference writes it, early stopping on the validation loss
    (margin 1e-7, patience 12) keeping the best parameters. The
    validation pass and every prediction run through ``mlp_surrogate``."""

    name = "mlp"

    def __init__(self, hidden=(100, 50), lr=2e-3, batch=1024, max_epochs=120,
                 patience=12, l2=1e-6, seed=0, device=None):
        super().__init__(device)
        self.hidden = hidden
        self.lr = lr
        self.batch = batch
        self.max_epochs = max_epochs
        self.patience = patience
        self.l2 = l2
        self.seed = seed

    def _init(self, gen, dims):
        """He-normal weights and zero biases, ``[{"w", "b"}, ...]``, drawn
        from ``gen`` on its device."""
        params = []
        for i in range(len(dims) - 1):
            w = torch.randn((dims[i], dims[i + 1]), generator=gen,
                            device=gen.device) * float(np.sqrt(2.0 / dims[i]))
            params.append({"w": w.float(),
                           "b": torch.zeros((dims[i + 1],),
                                            dtype=torch.float32,
                                            device=gen.device)})
        return params

    @staticmethod
    def _apply(params, x):
        h = x
        for i, lyr in enumerate(params):
            h = h @ lyr["w"] + lyr["b"]
            if i < len(params) - 1:
                h = torch.relu(h)
        return h[..., 0]

    @staticmethod
    def _forward(params, x):
        """``_apply`` through ``mlp_surrogate`` (3 layers)."""
        (l0, l1, l2) = params
        return mlp_surrogate(x, l0["w"], l0["b"], l1["w"], l1["b"],
                             l2["w"], l2["b"])

    def fit(self, xtr, ytr, xva, yva):
        t0 = time.time()
        dev = self._dev()
        self.sx = Standardizer.fit(xtr)
        self.sy = Standardizer.fit(ytr[:, None])
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        x = f32(self.sx.apply(xtr))
        y = f32(self.sy.apply(ytr[:, None])[:, 0])
        xv = f32(self.sx.apply(xva))
        yv = f32(self.sy.apply(yva[:, None])[:, 0])
        dims = (x.shape[1], *self.hidden, 1)
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed)
        # every parameter a view of one buffer: one gradient and one Adam
        # update a step, with the reference's per-element arithmetic
        flat = torch.cat([lyr[k].reshape(-1) for lyr in self._init(gen, dims)
                          for k in ("w", "b")]).requires_grad_(True)
        m = torch.zeros_like(flat)
        v = torch.zeros_like(flat)
        lr, l2 = self.lr, self.l2

        def step(t, xb, yb):
            params = _unflatten(flat, dims)
            pred = self._apply(params, xb)
            loss = torch.mean(torch.square(pred - yb)) + l2 * sum(
                torch.sum(torch.square(lyr["w"])) for lyr in params)
            (g,) = torch.autograd.grad(loss, flat)
            with torch.no_grad():
                m.mul_(0.9).add_(g * 0.1)
                v.mul_(0.999).add_(torch.square(g) * 0.001)
                flat.sub_(lr * ops.div(m, 1 - 0.9 ** t)
                          / (torch.sqrt(ops.div(v, 1 - 0.999 ** t)) + 1e-8))

        rng = np.random.default_rng(self.seed)
        n = x.shape[0]
        best = (np.inf, flat.detach().clone())
        bad = 0
        t = 0
        for _epoch in range(self.max_epochs):
            perm = torch.as_tensor(rng.permutation(n), device=dev)
            for i in range(0, n - self.batch + 1, self.batch):
                idx = perm[i:i + self.batch]
                t += 1
                step(t, x[idx], y[idx])
            with torch.no_grad():
                vl = float(torch.mean(torch.square(
                    self._forward(_unflatten(flat, dims), xv) - yv)))
            if vl < best[0] - 1e-7:
                best = (vl, flat.detach().clone())
                bad = 0
            else:
                bad += 1
                if bad >= self.patience:
                    break
        self.params = [{k: a.cpu().numpy() for k, a in lyr.items()}
                       for lyr in _unflatten(best[1], dims)]
        self.train_time = time.time() - t0
        return self

    def predict_t(self, x):
        dev = self._dev()
        xs = self.sx.apply_t(self._rows(x))
        p = [{k: torch.as_tensor(a, device=dev) for k, a in lyr.items()}
             for lyr in self.params]
        yn = self._forward(p, xs)
        return yn * float(self.sy.sd[0]) + float(self.sy.mu[0])


def _unflatten(buf, dims):
    """Layer views ``[{"w": (d_i, d_i+1), "b": (d_i+1,)}, ...]`` of one
    parameter buffer, in the order the buffer was built."""
    out, i = [], 0
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        w = buf[i:i + d_in * d_out].view(d_in, d_out)
        i += d_in * d_out
        out.append({"w": w, "b": buf[i:i + d_out]})
        i += d_out
    return out


MODEL_FAMILIES = {
    "mean": MeanModel,
    "table": TableModel,
    "linear": LinearModel,
    "gbdt": GBDTModel,
    "mlp": MLPModel,
}
