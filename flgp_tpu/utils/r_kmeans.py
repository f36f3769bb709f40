"""R's ``stats::kmeans`` Hartigan–Wong path, bit-faithful, on the R RNG stream.

The reference's anchors come from a C++→R callback
``stats::kmeans(x=X_all, centers=s, iter.max=100, nstart=1)``
(/root/reference/src/Utils.cpp:37-42).  With nstart=1, R draws the initial
centers as ``x[sample.int(m, k), ]`` on the session RNG and runs the
Hartigan–Wong algorithm (Applied Statistics AS 136, Hartigan & Wong 1979) —
the one remaining stochastic input between our pipeline and the committed
README goldens.  This module re-implements that semantics in NumPy, seeded by
``utils.r_rng.RRng``, so parity runs use the *identical* anchor set the
goldens were committed on (see PARITY.md).

Implementation note: this is a from-scratch transcription of the published
AS 136 algorithm (optimal-transfer + quick-transfer stages with live sets),
not a port of R's Fortran/C sources.  Host NumPy is appropriate — it runs
once per parity fit on a (n≈4000, k≈500) problem; the production
subsampler is ops.kmeans.
"""

from __future__ import annotations

import numpy as np

_BIG = 1.0e30


def _closest_two(A: np.ndarray, C: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Closest and second-closest center per point (squared Euclidean);
    ties resolve to the lowest center index, as AS 136's strict-less scan."""
    d = ((A[:, None, :] - C[None, :, :]) ** 2).sum(-1)
    order = np.argsort(d, axis=1, kind="stable")
    return order[:, 0].astype(np.int64), order[:, 1].astype(np.int64)


def hartigan_wong(
    A: np.ndarray, C0: np.ndarray, iter_max: int = 10
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """AS 136 k-means.

    A (m, n) points, C0 (k, n) initial centers.  Returns (centers, ic1
    assignments, within-cluster sums of squares, ifault) with ifault
    semantics as AS 136: 0 converged, 1 empty initial cluster, 2 iteration
    limit reached.
    """
    A = np.asarray(A, np.float64)
    C = np.asarray(C0, np.float64).copy()
    m, n = A.shape
    k = C.shape[0]
    if k <= 1 or k >= m:
        raise ValueError("AS 136 requires 1 < k < m (ifault 3)")

    ic1, ic2 = _closest_two(A, C)

    nc = np.bincount(ic1, minlength=k).astype(np.int64)
    if (nc == 0).any():
        return C, ic1, np.zeros(k), 1

    # cluster means
    for L in range(k):
        C[L] = A[ic1 == L].mean(axis=0)

    an1 = np.where(nc > 1, nc / np.maximum(nc - 1.0, 1.0), _BIG)
    an2 = nc / (nc + 1.0)
    itran = np.ones(k, dtype=bool)
    ncp = np.full(k, -1, dtype=np.int64)   # "last updated at step" markers
    d = np.zeros(m)
    live = np.zeros(k, dtype=np.int64)
    indx = 0
    ifault = 2

    def transfer(i: int, l1: int, l2: int) -> None:
        """Move point i from cluster l1 to l2, updating C, nc, an1, an2."""
        al1 = float(nc[l1]); alw = al1 - 1.0
        al2 = float(nc[l2]); alt = al2 + 1.0
        C[l1] = (C[l1] * al1 - A[i]) / alw
        C[l2] = (C[l2] * al2 + A[i]) / alt
        nc[l1] -= 1
        nc[l2] += 1
        an2[l1] = alw / al1
        an1[l1] = alw / (alw - 1.0) if alw > 1.0 else _BIG
        an1[l2] = alt / al2
        an2[l2] = alt / (alt + 1.0)
        ic1[i] = l2
        ic2[i] = l1

    for _ij in range(iter_max):
        # ---- optimal-transfer stage (OPTRA) ------------------------------
        live[itran] = m + 1
        for i in range(m):
            indx += 1
            l1 = int(ic1[i]); ll = int(ic2[i])
            if nc[l1] != 1:
                # update D(i) if cluster l1 changed since it was computed
                if ncp[l1] != 0:
                    d[i] = ((A[i] - C[l1]) ** 2).sum() * an1[l1]
                # search all live clusters (vectorized over k)
                dist = ((C - A[i]) ** 2).sum(axis=1)
                r2_all = dist * an2
                skip = np.zeros(k, dtype=bool)
                if i + 1 >= live[l1]:
                    skip = (i + 1) >= live          # both out of the live set
                skip[l1] = True
                cand = np.where(skip, np.inf, r2_all)
                # the scan starts from R2 = dist(l2)*an2(l2), then takes any
                # strictly smaller candidate, lowest index first
                r2 = r2_all[ll]
                l2 = ll
                cand[ll] = np.inf
                j = int(np.argmin(cand))
                if cand[j] < r2:
                    r2 = cand[j]
                    l2 = j
                if r2 < d[i]:
                    indx = 0
                    live[l1] = m + i + 1
                    live[l2] = m + i + 1
                    ncp[l1] = i + 1
                    ncp[l2] = i + 1
                    transfer(i, l1, l2)
                else:
                    ic2[i] = l2
            if indx == m:
                break
        if indx == m:
            ifault = 0
            break
        itran[:] = False
        live -= m

        # ---- quick-transfer stage (QTRAN) --------------------------------
        # R caps quick-transfer at 50·m steps (ifault 4: warn and proceed)
        icoun = 0
        istep = 0
        qtran_max = 50 * m
        while True:
            done = False
            for i in range(m):
                if istep >= qtran_max:
                    ifault = 4
                    done = True
                    break
                icoun += 1
                istep += 1
                l1 = int(ic1[i]); l2 = int(ic2[i])
                if nc[l1] != 1:
                    if istep <= ncp[l1]:
                        d[i] = ((A[i] - C[l1]) ** 2).sum() * an1[l1]
                    if istep < ncp[l1] or istep < ncp[l2]:
                        r2 = d[i] / an2[l2]
                        dd = ((A[i] - C[l2]) ** 2).sum()
                        if dd < r2:
                            icoun = 0
                            indx = 0
                            itran[l1] = True
                            itran[l2] = True
                            ncp[l1] = istep + m
                            ncp[l2] = istep + m
                            transfer(i, l1, l2)
                if icoun == m:
                    done = True
                    break
            if done:
                break
        if ifault == 4:  # R returns immediately on the QTRAN cap, then warns
            break

        if k == 2:
            ifault = 0
            break
        ncp[:] = 0

    # final pass: recompute centers as exact means + WSS (AS 136 tail)
    wss = np.zeros(k)
    for L in range(k):
        members = A[ic1 == L]
        C[L] = members.mean(axis=0)
        wss[L] = ((members - C[L]) ** 2).sum()
    return C, ic1, wss, ifault


def r_kmeans(rng, X: np.ndarray, k: int, iter_max: int = 100):
    """``stats::kmeans(X, k, iter.max)`` with nstart=1 on the given RRng.

    Draws initial centers as ``X[sample.int(m, k), ]`` (R's kmeans source;
    continuous data never hits the duplicate-row redraw branch), runs
    Hartigan–Wong, and returns (centers (k, d), sizes (k,)) — the exact
    shape subsample_cpp consumes (src/Utils.cpp:37-45).
    """
    X = np.asarray(X, np.float64)
    m = X.shape[0]
    init_rows = rng.sample_int(m, k) - 1
    C0 = X[init_rows]
    if len(np.unique(init_rows)) != k:
        raise ValueError("duplicate initial centers — R would redraw from unique rows")
    C, ic1, _wss, ifault = hartigan_wong(X, C0, iter_max)
    if ifault == 1:
        raise RuntimeError("empty cluster: try a better set of initial centers")
    sizes = np.bincount(ic1, minlength=k).astype(np.float64)
    return C, sizes
