"""UMI deduplication: batched pairwise-hamming clustering.

The capability the reference's alpha subpackage aimed at but never
finished (reference umi/README.md:1); semantics follow the established
umi_tools algorithms the reference benchmarks against
(tests/benchmark.py's umi_tools edit-distance comparison):

  unique       - exact UMIs only (degenerate case: one cluster per UMI)
  cluster      - connected components of the <=threshold hamming graph
  adjacency    - greedy: highest-count node absorbs its direct neighbours,
                 repeat on the remainder
  directional  - edge u->v only if count(u) >= 2*count(v) - 1; clusters
                 are BFS trees from high-count roots (the umi_tools default
                 and the standard for sequencing-error collapse)

Pipeline shape (each stage's why lives on its function):

  group     - unique (insert, UMI) keys + counts + per-item inverse via
              the threaded native hash counter (_unique_rows); uniform-
              length inputs take a fully vectorized matrix path, ragged
              lists a length-bucketed variant of it (one bucket per read
              length, re-ranked to global first-occurrence order), and an
              [N, L] uint8 matrix is accepted directly (zero per-read
              Python objects).
  adjacency - packed 2-bit words; [block, U] distance slabs from the
              measured-fastest pairwise formulation
              (ops.pairwise_hamming_auto), reduced ON DEVICE to
              per-row neighbour indices by hierarchical max-extraction
              (never lax.top_k - it lowers to a per-row sort), the whole
              matrix in ONE compiled program (lax.map), with optional
              row-band sharding over a device mesh (dist/umi.py).
              Host traffic is O(U*k), memory O(block * U).
  collapse  - host graph walk over the sparse lists, O(edges).
"""

from __future__ import annotations

import numpy as np

from ..constants import MAX_64_NT

# Memory budget for one pairwise row block: block_rows * U int32 distances
# stay under ~1 GiB (16384^2 * 4 B).
_PAIR_BUDGET = 16384 * 16384

_METHODS = ("unique", "cluster", "adjacency", "directional")


def _pack_validate_matrix(mat, lengths):
    """Pack an [N, <=32] uint8 UMI byte matrix -> ([N, 2] words, validated),
    raising the reference's error on any invalid base."""
    from ..constants import UNSUPPORTED_BASE_MSG
    from ..count.ingest import pack_validate_padded

    width = 32
    n = mat.shape[0]
    if mat.shape[1] != width:
        mat = np.pad(mat, ((0, 0), (0, width - mat.shape[1])))
    # Batch-dim pow2 padding + validation live in one shared helper
    # (count/ingest.pack_validate_padded) - an arbitrary unique-UMI count
    # would otherwise recompile the pack per dataset.
    lengths = np.ascontiguousarray(lengths, np.int32)
    words, ok = pack_validate_padded(np.ascontiguousarray(mat), lengths,
                                     min_pad=1)
    if not ok.all():
        i = int(np.argmin(ok))
        bad = mat[i, :lengths[i]].tobytes().decode("ascii", "replace")
        raise Exception(f"{UNSUPPORTED_BASE_MSG} in UMI {bad!r}")
    return words[:n]


def _pack_validate_umis(uniq):
    """Pack a list of unique UMI bytes -> ([U, 2] words, [U] lengths),
    raising the reference's error on any invalid base."""
    width = 32
    lengths = np.fromiter(map(len, uniq), np.int32, len(uniq))
    if lengths.size and lengths.max() > MAX_64_NT:
        raise ValueError("UMIs longer than 32 nt are not supported")
    if lengths.size and lengths.min() == lengths.max():
        # Fixed-length UMIs (the overwhelmingly common case): one
        # concatenate + reshape instead of a 100k-iteration Python loop
        # (measured 1.5 s at U = 100k).
        mat = np.zeros((len(uniq), width), np.uint8)
        mat[:, :lengths[0]] = np.frombuffer(
            b"".join(uniq), np.uint8).reshape(len(uniq), lengths[0])
    else:
        mat = np.zeros((len(uniq), width), np.uint8)
        for i, u in enumerate(uniq):
            mat[i, :len(u)] = np.frombuffer(u, np.uint8)
    return _pack_validate_matrix(mat, lengths), lengths


def _unique_rows(mat):
    """np.unique(mat, axis=0, return_counts+inverse) in global
    first-occurrence order (dict-insertion parity with the Python
    grouping paths), via the threaded native hash counter: returns
    (unique [M, L] uint8, counts [M] int64, inverse [N] int64), or None
    when the native library is unavailable."""
    from ..io.native import host_count_native

    n, ncol = mat.shape
    if ncol == 0:
        # Zero-width rows are all equal.
        return (np.zeros((1, 0), np.uint8), np.array([n], np.int64),
                np.zeros(n, np.int64))
    pad = -ncol % 4
    if pad:
        mat = np.pad(mat, ((0, 0), (0, pad)))
    words = np.ascontiguousarray(mat).view(np.uint32)
    res = host_count_native(words, np.full(n, ncol, np.int32),
                            return_inverse=True)
    if res is None:
        return None
    uw, _, counts, inv = res
    m = len(counts)
    # The native table is first-occurrence-ordered per hash partition;
    # re-rank globally.  Reversed fancy assignment keeps the SMALLEST
    # input index per unique id (later writes win, so write descending).
    first = np.empty(m, np.int64)
    first[inv[::-1]] = np.arange(n - 1, -1, -1, dtype=np.int64)
    order = np.argsort(first, kind="stable")
    rank = np.empty(m, np.int64)
    rank[order] = np.arange(m, dtype=np.int64)
    uniq_mat = uw.view(np.uint8).reshape(m, ncol + pad)[:, :ncol][order]
    return np.ascontiguousarray(uniq_mat), counts[order], rank[inv]


def umi_adjacency(words, lengths, threshold: int = 1) -> np.ndarray:
    """[U, W] packed UMIs -> boolean [U, U] adjacency (hamming <= threshold
    and equal length).  Dense; for bounded-memory neighbour lists at scale
    use _neighbor_lists (what dedup_umis/dedup_reads call)."""
    from ..ops import pairwise_hamming_auto

    dist = np.asarray(pairwise_hamming_auto(words, words))
    same_len = np.equal.outer(np.asarray(lengths), np.asarray(lengths))
    return (dist <= threshold) & same_len


# Per-row neighbour cap for the device-side extraction.  UMI graphs are
# sparse (neighbours = sequencing-error variants; measured max 4 on 100k
# random 12-mers at threshold 1, but error-clustered libraries grow
# variant fans up to 3L per unit of threshold); rows exceeding the cap
# are re-extracted in batches with _OVERFLOW_K (fetch stays tiny), and
# only rows beyond THAT (threshold >= 2 pathologies) pay a dense fetch.
_NEIGHBOR_K = 16
_OVERFLOW_K = 128


def _neighbor_block_device(a_words, a_lengths, a_gids, words, lengths, gids,
                           row0, threshold: int, k: int):
    """One [B, U] adjacency block reduced ON DEVICE to per-row neighbour
    indices: (idx [B, k] ascending, cnt [B] true neighbour count).  Only
    B*k indices + B counts cross the device->host boundary instead of the
    dense B*U distance slab - at U = 100k uniques that is the difference
    between ~40 GB and ~5 MB of fetch traffic for the whole matrix.

    Extraction is k rounds of hierarchical max, NOT lax.top_k: scores are
    the distinct values U - col, so a row max alone recovers the smallest
    remaining neighbour column, while top_k over 100k columns lowers to a
    full per-row sort.  The score slab is pre-reduced once to
    per-128-column segment maxima; each round then takes the global max
    from the [B, U/128] segment table, re-scans only the 128-column
    segment it came from (masking columns <= the taken one - extraction
    is ascending, so earlier picks are always below the current column),
    and patches that one segment maximum.  Slab traffic: ~2 passes total instead of
    ~3 per round."""
    import jax
    import jax.numpy as jnp

    b = a_words.shape[0]
    rows = jax.lax.broadcasted_iota(jnp.int32, (b,), 0) + row0
    score, cnt = _adjacency_score(a_words, a_lengths, a_gids, rows,
                                  words, lengths, gids, threshold)
    return _extract_ascending(score, k), cnt


def _adjacency_score(a_words, a_lengths, a_gids, a_rows, words, lengths,
                     gids, threshold: int):
    """Masked [B, U] adjacency -> (score, cnt): score is U - col for
    neighbours (all distinct per row - the index-encoding trick the
    extraction relies on), 0 otherwise; self edges excluded by the global
    row ids in a_rows."""
    import jax
    import jax.numpy as jnp

    from ..ops import pairwise_hamming_auto

    u = words.shape[0]
    dist = pairwise_hamming_auto(a_words, words)          # [B, U]
    adj = (dist <= threshold) & (a_lengths[:, None] == lengths[None, :])
    adj = adj & (a_gids[:, None] == gids[None, :])
    b = a_words.shape[0]
    cols = jax.lax.broadcasted_iota(jnp.int32, (b, u), 1)
    adj = adj & (cols != a_rows[:, None])
    cnt = jnp.sum(adj, axis=1).astype(jnp.int32)
    score = jnp.where(adj, u - cols, 0)
    return score, cnt


def _extract_ascending(score, k: int):
    """Per-row ascending neighbour columns from an index-encoding score
    matrix, via k rounds of hierarchical max (see _neighbor_block_device
    docstring).  Empty slots hold U."""
    import jax
    import jax.numpy as jnp

    b, u = score.shape
    seg = 128 if u % 128 == 0 else u
    s_cnt = u // seg
    score3 = score.reshape(b, s_cnt, seg)
    seg_max = jnp.max(score3, axis=2)                     # [B, S]

    def take(j, state):
        seg_max, idx = state
        v = jnp.max(seg_max, axis=1)                      # [B]
        c = u - v                                         # col; u if empty
        idx = jax.lax.dynamic_update_slice_in_dim(
            idx, c[:, None].astype(jnp.int32), j, axis=1)
        s = jnp.minimum(c // seg, s_cnt - 1)              # clamp empty rows
        segment = jnp.take_along_axis(
            score3, s[:, None, None], axis=1)[:, 0]       # [B, seg]
        within = s[:, None] * seg + jax.lax.broadcasted_iota(
            jnp.int32, (b, seg), 1)
        segment = jnp.where(within > c[:, None], segment, 0)
        new_max = jnp.max(segment, axis=1)
        s_iota = jax.lax.broadcasted_iota(jnp.int32, (b, s_cnt), 1)
        seg_max = jnp.where(s_iota == s[:, None], new_max[:, None], seg_max)
        return seg_max, idx

    idx0 = jnp.full((b, k), u, jnp.int32)
    _, idx = jax.lax.fori_loop(0, k, take, (seg_max, idx0))
    return idx


def _overflow_block_device(sel_words, sel_lengths, sel_gids, sel_rows,
                           words, lengths, gids, threshold: int, k: int):
    """Re-extraction for a fixed-size batch of rows whose neighbour count
    exceeded the main pass's cap: same hierarchical extraction at a larger
    k ([P, k] indices ~ 100 KB fetched, vs a dense [P, U] slab ~ 26 MB at
    U = 100k)."""
    score, cnt = _adjacency_score(sel_words, sel_lengths, sel_gids,
                                  sel_rows, words, lengths, gids, threshold)
    return _extract_ascending(score, k), cnt


def _dense_rows_device(sel_words, sel_lengths, sel_gids, sel_rows,
                       words, lengths, gids, threshold: int):
    """Dense adjacency for a fixed-size batch of rows beyond even
    _OVERFLOW_K neighbours (threshold >= 2 pathologies): one [P, U] bool
    fetch instead of one device round-trip per row."""
    score, _ = _adjacency_score(sel_words, sel_lengths, sel_gids, sel_rows,
                                words, lengths, gids, threshold)
    return score > 0


def _neighbor_all_device(words, lengths, gids, threshold: int, k: int,
                         block: int):
    """Whole adjacency in ONE compiled program: lax.map over row blocks,
    each [block, U] distance slab reduced to per-row neighbour indices
    before the next block starts.  One dispatch + one fetch for the
    entire matrix instead of a dispatch and a fetch per block."""
    import jax
    import jax.numpy as jnp

    u = words.shape[0]
    nb = u // block

    def body(i):
        lo = i * block
        aw = jax.lax.dynamic_slice_in_dim(words, lo, block, 0)
        al = jax.lax.dynamic_slice_in_dim(lengths, lo, block, 0)
        ag = jax.lax.dynamic_slice_in_dim(gids, lo, block, 0)
        return _neighbor_block_device(aw, al, ag, words, lengths, gids,
                                      lo, threshold, k)

    idx, cnt = jax.lax.map(body, jnp.arange(nb, dtype=jnp.int32))
    return idx.reshape(u, k), cnt.reshape(u)


_NEIGHBOR_STEP = None
_OVERFLOW_STEP = None
_DENSE_ROWS_STEP = None

# Overflow rows are re-derived in fixed-size batches (one compile shape).
_DENSE_ROWS_BATCH = 256


def _neighbor_step():
    """Process-wide jitted _neighbor_all_device: one compile cache per
    process, not per dedup call.  Lazy so importing the package never
    initializes a jax backend (multi-host rule, dist/mesh.py)."""
    global _NEIGHBOR_STEP
    if _NEIGHBOR_STEP is None:
        import jax

        _NEIGHBOR_STEP = jax.jit(
            _neighbor_all_device,
            static_argnames=("threshold", "k", "block"))
    return _NEIGHBOR_STEP


def _overflow_step():
    global _OVERFLOW_STEP
    if _OVERFLOW_STEP is None:
        import jax

        _OVERFLOW_STEP = jax.jit(_overflow_block_device,
                                 static_argnames=("threshold", "k"))
    return _OVERFLOW_STEP


def _dense_rows_step():
    global _DENSE_ROWS_STEP
    if _DENSE_ROWS_STEP is None:
        import jax

        _DENSE_ROWS_STEP = jax.jit(_dense_rows_device,
                                   static_argnames=("threshold",))
    return _DENSE_ROWS_STEP


def _neighbor_lists(words, lengths, threshold, gids=None, block=None,
                    mesh=None):
    """Sparse adjacency: neighbours[i] = indices j != i with
    hamming(i, j) <= threshold, equal lengths, and (optionally) equal
    group ids.  Each [block, U] distance slab is computed AND reduced on
    device (per-row index extraction, _neighbor_block_device); host
    memory and transfer are O(U * k + edges), never O(U^2).

    With a mesh, row bands split over the 'data' axis (dist/umi.py) - the
    quadratic stage scales with device count while this host logic is
    unchanged."""
    import jax
    import jax.numpy as jnp

    from ..ops.pallas_kernels import pairwise_formulation

    u = len(lengths)
    lengths = np.asarray(lengths)
    # Resolve the pairwise formulation on the host: its one-time
    # calibration times compiled programs and cannot run inside the
    # traced neighbour programs below.
    pairwise_formulation(np.shape(words)[1])
    if block is None:
        block = max(256, min(u, _PAIR_BUDGET // max(u, 1)))
        # Multiple of 128 so the padded column count segments evenly
        # (the extraction pre-reduces over 128-column segments).
        block = -(-block // 128) * 128
    k = min(_NEIGHBOR_K, u)
    # Pad the row count to a multiple of block (x devices) with rows that
    # match nothing (length -1); their neighbour lists come back empty
    # and are sliced off below.
    quantum = block * (mesh.devices.size if mesh is not None else 1)
    u_pad = -(-u // quantum) * quantum
    words_np = np.asarray(words)
    if u_pad != u:
        words_np = np.pad(words_np, ((0, u_pad - u), (0, 0)))
    lens_pad = np.full(u_pad, -1, np.int32)
    lens_pad[:u] = lengths.astype(np.int32)
    gids_np = (np.asarray(gids).astype(np.int32) if gids is not None
               else np.zeros(u, np.int32))
    gids_pad = np.zeros(u_pad, np.int32)
    gids_pad[:u] = gids_np
    # Default-device copies are only needed by the single-device step
    # and the (rare) overflow re-extraction; the mesh path ships its own
    # replicated operands, so don't pay a second transfer up front.
    words_d = lengths_d = gids_d = None

    def _to_default_device():
        nonlocal words_d, lengths_d, gids_d
        if words_d is None:
            words_d = jnp.asarray(words_np)
            lengths_d = jnp.asarray(lens_pad)
            gids_d = jnp.asarray(gids_pad)

    if mesh is not None:
        from ..dist.umi import neighbors_sharded_step

        idx, cnt = neighbors_sharded_step(mesh, threshold, k, block)(
            words_np, lens_pad, gids_pad,
            np.arange(u_pad, dtype=np.int32))
        idx, cnt = _fetch_row_sharded(idx), _fetch_row_sharded(cnt)
    else:
        _to_default_device()
        idx, cnt = _neighbor_step()(
            words_d, lengths_d, gids_d,
            threshold=threshold, k=k, block=block)
        idx, cnt = jax.device_get((idx, cnt))
    idx = np.asarray(idx)[:u]
    cnt = np.asarray(cnt)[:u]
    # Empty slots carry the padded row count (max of the score encoding).
    valid = idx < u_pad

    # Max-extraction of score u - col yields columns ascending per row;
    # boolean masking flattens row-major, so one mask + split materializes
    # every per-row list without a u-iteration Python loop.
    flat = idx[valid]
    neighbors = ([] if u == 0 else
                 np.split(flat, np.cumsum(valid.sum(axis=1))[:-1]))

    # Rows with more than k neighbours (error-variant fans on dup-heavy
    # libraries) are re-extracted in fixed-size batches at a larger cap -
    # [P, _OVERFLOW_K] indices fetched, not dense rows.  Rows beyond even
    # that (threshold >= 2 pathologies; threshold 1 is bounded by
    # 3L <= 96 < _OVERFLOW_K) fall through to one dense batched fetch.
    over = np.flatnonzero(cnt > k)
    if over.size:
        _to_default_device()
        k2 = min(_OVERFLOW_K, u_pad)
        step = _overflow_step()
        p = _DENSE_ROWS_BATCH
        still = []
        for lo in range(0, over.size, p):
            sel = over[lo:lo + p]
            sel_pad = np.zeros(p, np.int64)
            sel_pad[:sel.size] = sel
            idx2, cnt2 = jax.device_get(step(
                words_d[sel_pad], lengths_d[sel_pad], gids_d[sel_pad],
                jnp.asarray(sel_pad.astype(np.int32)),
                words_d, lengths_d, gids_d, threshold=threshold, k=k2))
            idx2, cnt2 = np.asarray(idx2), np.asarray(cnt2)
            for i, r in enumerate(sel):
                if cnt2[i] <= k2:
                    neighbors[r] = idx2[i][idx2[i] < u_pad]
                else:
                    still.append(r)
        for lo in range(0, len(still), p):
            sel = np.asarray(still[lo:lo + p], np.int64)
            sel_pad = np.zeros(p, np.int64)
            sel_pad[:sel.size] = sel
            adj = np.asarray(jax.device_get(_dense_rows_step()(
                words_d[sel_pad], lengths_d[sel_pad], gids_d[sel_pad],
                jnp.asarray(sel_pad.astype(np.int32)),
                words_d, lengths_d, gids_d, threshold=threshold)))
            for i, r in enumerate(sel):
                neighbors[r] = np.flatnonzero(adj[i][:u])
    return neighbors


def _fetch_row_sharded(x):
    """Host numpy of a row-sharded mesh output, multi-controller safe and
    in GLOBAL row order for any mesh device order (neighbor row i must
    describe UMI i).  Shared implementation: dist.pipeline.gather_row_sharded."""
    from ..dist.pipeline import gather_row_sharded

    return gather_row_sharded(x)


def _edge_csr(neighbors):
    """Sparse lists -> CSR (indptr [U+1] int64, indices [E] int64)."""
    u = len(neighbors)
    deg = np.fromiter(map(len, neighbors), np.int64, u)
    indptr = np.zeros(u + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    if int(indptr[-1]) == 0:
        return indptr, np.zeros(0, np.int64)
    indices = np.concatenate([np.asarray(x, np.int64)
                              for x in neighbors if len(x)])
    return indptr, indices


def _components(neighbors):
    """Connected components over sparse lists; returns each node's
    component root = the component's MINIMUM node index (identical to the
    previous seeded-BFS labels, whose first seed per component was its
    lowest index).  Vectorized min-label propagation with pointer-jumping
    path compression - O((U + E) log U) numpy array work instead of a
    per-node Python walk (the walk was ~1 us/node + ~1 us/edge; at 10M
    uniques that is seconds of pure interpreter time)."""
    u = len(neighbors)
    labels = np.arange(u, dtype=np.int64)
    if u == 0:
        return labels
    indptr, dst = _edge_csr(neighbors)
    if len(dst) == 0:
        return labels
    src = np.repeat(np.arange(u, dtype=np.int64), np.diff(indptr))
    while True:
        m = labels.copy()
        # Pull phase: adjacency is symmetric (hamming; every edge appears
        # in both rows' lists), so one directed pass reaches both ends.
        np.minimum.at(m, src, labels[dst])
        # Compression: m[i] <= i throughout (init arange + minimum), so
        # m is a parent forest and jumping strictly descends.
        while True:
            mm = m[m]
            if np.array_equal(mm, m):
                break
            m = mm
        if np.array_equal(m, labels):
            return labels
        labels = m


def _greedy_absorb(neighbors, counts, directional: bool):
    """adjacency / directional collapse over sparse lists: iterate nodes by
    descending count; an unassigned node roots a cluster and absorbs
    unassigned neighbours (direct only for adjacency; BFS through
    count-ordered edges for directional, edge u->v iff
    counts[u] >= 2 * counts[v] - 1).

    The walk is inherently sequential (a later root may not steal an
    earlier root's nodes), so it runs in the native extension when built
    (csrc ssq_greedy_absorb - same traversal, ~100x less per-edge
    overhead); the Python loop below is its behavioural twin and the
    fallback (tests/test_umi.py asserts they agree)."""
    from ..io.native import greedy_absorb_native

    u = len(neighbors)
    counts = np.asarray(counts, np.int64)
    order = np.argsort(-counts, kind="stable")
    indptr, indices = _edge_csr(neighbors)
    native = greedy_absorb_native(indptr, indices, counts, order,
                                  directional)
    if native is not None:
        return native
    labels = np.full(u, -1, np.int64)
    for root in order:
        if labels[root] >= 0:
            continue
        labels[root] = root
        frontier = [root]
        while frontier:
            node = frontier.pop()
            for nbr in neighbors[node]:
                if labels[nbr] >= 0:
                    continue
                if directional and counts[node] < 2 * counts[nbr] - 1:
                    continue
                labels[nbr] = root
                if directional:
                    frontier.append(nbr)
        # adjacency method: only direct neighbours of the root absorb,
        # handled by not extending the frontier above.
    return labels


def _collapse(neighbors, counts, method):
    if method == "cluster":
        return _components(neighbors)
    return _greedy_absorb(neighbors, counts, method == "directional")


def _relabel(roots, counts):
    """roots -> (dense cluster labels, representative node per cluster =
    the lowest-index max-count member).  Fully vectorized: O(U log U)."""
    uniq_roots, labels = np.unique(roots, return_inverse=True)
    # Sort by (label asc, count desc, index asc); the first row of each
    # label run is its representative.
    order = np.lexsort((np.arange(len(roots)), -counts, labels))
    first = np.searchsorted(labels[order], np.arange(len(uniq_roots)))
    rep_nodes = order[first]
    return labels.astype(np.int64), rep_nodes


def split_read(read: bytes, len_5p: int, len_3p: int):
    """(5' UMI, insert, 3' UMI) split shared by UMIFactory and dedup_reads.

    A read that is entirely UMI yields an empty insert."""
    if len_5p < 0 or len_3p < 0:
        raise ValueError("UMI lengths must be non-negative")
    n = len(read)
    if n < len_5p + len_3p:
        raise ValueError(
            f"Read of {n} nt is shorter than the UMI lengths "
            f"({len_5p} + {len_3p})")
    umi5 = read[:len_5p]
    umi3 = read[n - len_3p:] if len_3p else b""
    insert = read[len_5p:n - len_3p]
    return umi5, insert, umi3


def _cluster_unique(words, lengths, counts, method, threshold, gids=None,
                    candidates=None, block=None, mesh=None):
    """Shared collapse driver: returns root per unique key.  `candidates`
    restricts the (quadratic) adjacency work to the given key indices;
    keys outside it root themselves."""
    u = len(lengths)
    roots = np.arange(u)
    if method == "unique" or u < 2:
        return roots
    if candidates is None:
        candidates = np.arange(u)
    if len(candidates) < 2:
        return roots
    # Host-side gather of the candidate rows: device fancy-indexing would
    # compile one program per candidate-set size.
    words = np.asarray(words)
    sub_gids = gids[candidates] if gids is not None else None
    neighbors = _neighbor_lists(
        words[candidates], lengths[candidates], threshold,
        gids=sub_gids, block=block, mesh=mesh)
    sub_roots = _collapse(neighbors, counts[candidates], method)
    roots[candidates] = candidates[sub_roots]
    return roots


def dedup_umis(umis, threshold: int = 1, method: str = "directional",
               _block=None, mesh=None):
    """Collapse a list of UMIs (str/bytes) into clusters.

    Returns (labels, representatives): `labels[i]` is the cluster id of
    input i (ids are indices into `representatives`), and
    `representatives[c]` is the highest-count UMI of cluster c (bytes).
    """
    import collections

    if method not in _METHODS:
        raise ValueError(f"Unknown method: {method}")
    if len(umis) == 0:
        return np.zeros(0, np.int64), []

    # 2-D arrays are UMI matrices (one row per UMI); 1-D arrays of
    # str/bytes scalars flow through the generic list path below.
    matrix_unavailable = False  # the matrix path fails only when the
    # native library is missing - retrying it with a rebuilt matrix can
    # never succeed, so remember and skip the second O(N*L) copy pass
    if isinstance(umis, np.ndarray) and umis.ndim == 2:
        if umis.dtype != np.uint8:
            raise TypeError("array input must be a 2-D uint8 UMI matrix")
        if umis.shape[1] > MAX_64_NT:
            raise ValueError("UMIs longer than 32 nt are not supported")
        res = _dedup_umi_matrix(np.ascontiguousarray(umis), method,
                                threshold, _block, mesh)
        if res is not None:
            return res
        matrix_unavailable = True
        umis = [umis[i].tobytes() for i in range(len(umis))]

    norm = [u.encode("ascii") if isinstance(u, str) else bytes(u)
            for u in umis]

    # Vectorized grouping: the whole stage is native hash-counts with
    # inverse, no per-item Python dict work.  Uniform lengths take the
    # single-matrix path; ragged lists the length-bucketed variant.
    lengths_all = np.fromiter(map(len, norm), np.int64, len(norm))
    if not matrix_unavailable and int(lengths_all.max()) <= MAX_64_NT:
        lng = int(lengths_all[0])
        if (lengths_all == lng).all():
            res = _dedup_umi_matrix(
                np.frombuffer(b"".join(norm), np.uint8).reshape(
                    len(norm), lng),
                method, threshold, _block, mesh)
        else:
            res = _dedup_umis_ragged(norm, lengths_all, method, threshold,
                                     _block, mesh=mesh)
        if res is not None:
            return res

    counter = collections.Counter(norm)
    uniq = list(counter)
    index = {u: i for i, u in enumerate(uniq)}
    inverse = np.fromiter((index[u] for u in norm), np.int64, len(norm))
    counts = np.fromiter((counter[u] for u in uniq), np.int64, len(uniq))

    words, lengths = _pack_validate_umis(uniq)
    roots = _cluster_unique(words, lengths, counts, method, threshold,
                            block=_block, mesh=mesh)
    labels_u, rep_nodes = _relabel(roots, counts)
    return labels_u[inverse], [uniq[i] for i in rep_nodes]


def _dedup_umi_matrix(mat, method, threshold, block, mesh=None):
    """Vectorized dedup_umis for an [N, L] uint8 UMI matrix.  Returns
    None when the native library is unavailable."""
    res = _unique_rows(mat)
    if res is None:
        return None
    uniq_mat, counts, inverse = res
    lengths = np.full(len(counts), mat.shape[1], np.int32)
    words = _pack_validate_matrix(uniq_mat, lengths)
    roots = _cluster_unique(words, lengths, counts, method, threshold,
                            block=block, mesh=mesh)
    labels_u, rep_nodes = _relabel(roots, counts)
    return labels_u[inverse], [uniq_mat[i].tobytes() for i in rep_nodes]


def _length_buckets(lengths_all):
    """Yield (length, ascending original indices) per distinct length in
    ascending length order - ONE stable argsort + searchsorted split, not
    an O(N) scan per distinct length (reads up to 1024 nt can have ~1000
    buckets).  Stability keeps each bucket's indices ascending, which the
    first-occurrence re-ranking in the ragged paths relies on."""
    order = np.argsort(lengths_all, kind="stable")
    sorted_lens = lengths_all[order]
    uniq_lens = np.unique(sorted_lens)
    bounds = np.searchsorted(sorted_lens, uniq_lens)
    bounds = np.append(bounds, len(order))
    for i, lng in enumerate(uniq_lens):
        yield int(lng), order[bounds[i]:bounds[i + 1]]


def _flat_rows(norm, lengths_all):
    """One C-level concatenation of a ragged bytes list + row offsets,
    so each length bucket's matrix is ONE vectorized numpy gather
    (flat[offsets[idx, None] + arange(lng)]) instead of a per-item
    Python generator join, which dominated the ragged grouping stage at
    10M reads on the host."""
    flat = np.frombuffer(b"".join(norm), np.uint8)
    offsets = np.zeros(len(norm) + 1, np.int64)
    np.cumsum(lengths_all, out=offsets[1:])
    return flat, offsets[:-1]


def _dedup_umis_ragged(norm, lengths_all, method, threshold, block,
                       mesh=None):
    """Length-bucketed vectorized dedup_umis for ragged UMI lists (the
    design of _dedup_reads_ragged applied to bare UMIs): UMIs of
    different lengths are distinct keys and never adjacent
    (_neighbor_lists masks unequal lengths), so grouping decomposes
    exactly by length; bucket uniques are re-ranked into global
    first-occurrence order for dict-path-identical labels and
    representatives.  Returns None when the native library is
    unavailable."""
    n = len(norm)
    width = 32
    mats, counts_parts, first_parts, len_parts = [], [], [], []
    inverse_global = np.empty(n, np.int64)
    u_total = 0
    flat, offsets = _flat_rows(norm, lengths_all)
    for lng, idx in _length_buckets(lengths_all):
        mat = flat[offsets[idx, None] + np.arange(lng, dtype=np.int64)]
        res = _unique_rows(mat)
        if res is None:
            return None
        uniq_mat, counts, inverse = res
        m = len(counts)
        first = np.empty(m, np.int64)
        first[inverse[::-1]] = idx[::-1]
        pad = np.zeros((m, width), np.uint8)
        pad[:, :lng] = uniq_mat
        mats.append(pad)
        counts_parts.append(counts)
        first_parts.append(first)
        len_parts.append(np.full(m, lng, np.int32))
        inverse_global[idx] = inverse + u_total
        u_total += m
    first = np.concatenate(first_parts)
    order = np.argsort(first, kind="stable")
    rank = np.empty(u_total, np.int64)
    rank[order] = np.arange(u_total, dtype=np.int64)
    mat = np.ascontiguousarray(np.concatenate(mats)[order])
    counts = np.concatenate(counts_parts)[order]
    lengths = np.concatenate(len_parts)[order]
    inverse_global = rank[inverse_global]
    words = _pack_validate_matrix(mat, lengths)
    roots = _cluster_unique(words, lengths, counts, method, threshold,
                            block=block, mesh=mesh)
    labels_u, rep_nodes = _relabel(roots, counts)
    reps = [mat[i, :lengths[i]].tobytes() for i in rep_nodes]
    return labels_u[inverse_global], reps


def _dedup_reads_matrix(mat, len_5p, len_3p, method, threshold, block,
                        mesh=None):
    """Vectorized dedup_reads for an [N, L] uint8 read matrix: a unique
    (insert, UMI) key is exactly a unique read (the read is the UMI ends
    around the insert), so grouping is one native hash-count with inverse
    over the raw read matrix, and gid assignment is a second one over the
    unique reads' insert columns.  First-occurrence ordering makes labels
    and representatives bit-identical to the Python dict path.  Returns
    None when the native library is unavailable."""
    length = mat.shape[1]
    res = _unique_rows(mat)
    if res is None:
        return None
    uniq_mat, counts, inverse = res
    ins_lo, ins_hi = len_5p, length - len_3p
    res_g = _unique_rows(np.ascontiguousarray(uniq_mat[:, ins_lo:ins_hi]))
    if res_g is None:
        return None
    gids = res_g[2]
    if len_3p:
        umi_mat = np.ascontiguousarray(np.concatenate(
            [uniq_mat[:, :len_5p], uniq_mat[:, ins_hi:]], axis=1))
    else:
        umi_mat = np.ascontiguousarray(uniq_mat[:, :len_5p])
    lengths = np.full(len(counts), len_5p + len_3p, np.int32)
    words = _pack_validate_matrix(umi_mat, lengths)

    group_sizes = np.bincount(gids)
    candidates = np.flatnonzero(group_sizes[gids] >= 2)
    roots = _cluster_unique(words, lengths, counts, method, threshold,
                            gids=gids, candidates=candidates, block=block,
                            mesh=mesh)
    labels_u, rep_nodes = _relabel(roots, counts)
    molecules = [(uniq_mat[i, ins_lo:ins_hi].tobytes(),
                  umi_mat[i].tobytes()) for i in rep_nodes]
    return labels_u[inverse], molecules


def _dedup_reads_ragged(norm, lengths_all, len_5p, len_3p, method,
                        threshold, block, mesh=None):
    """Length-bucketed vectorized dedup_reads for ragged read lists.

    Reads of different lengths can never share an insert (insert length
    = read length - fixed UMI lengths, and bytes of unequal length are
    unequal), so grouping decomposes exactly by read length: each bucket
    runs the same two native hash-counts as the uniform matrix path
    (_dedup_reads_matrix), then the per-bucket uniques are re-ranked into
    GLOBAL first-occurrence order so labels and molecules stay
    bit-identical to the Python dict path.  UMIs are fixed-width
    (len_5p + len_3p) across buckets, so one packed clustering pass
    covers everything - no per-read Python dict/Counter work anywhere.
    Returns None when the native library is unavailable.
    """
    n = len(norm)
    umi_len = len_5p + len_3p
    per_bucket = []  # (uniq_mat, ins_lo, ins_hi): molecule extraction
    umi_parts, counts_parts, gids_parts, first_parts = [], [], [], []
    bucket_parts, row_parts = [], []
    inverse_global = np.empty(n, np.int64)
    gid_offset = 0
    u_total = 0
    flat, offsets = _flat_rows(norm, lengths_all)
    for bi, (lng, idx) in enumerate(_length_buckets(lengths_all)):
        mat = flat[offsets[idx, None] + np.arange(lng, dtype=np.int64)]
        res = _unique_rows(mat)
        if res is None:
            return None
        uniq_mat, counts, inverse = res
        m = len(counts)
        ins_lo, ins_hi = len_5p, lng - len_3p
        res_g = _unique_rows(np.ascontiguousarray(uniq_mat[:, ins_lo:ins_hi]))
        if res_g is None:
            return None
        # Global first-occurrence read index per bucket-unique: idx is
        # ascending, so within-bucket first occurrence IS the global one
        # among this bucket's reads (reversed write keeps the smallest).
        first = np.empty(m, np.int64)
        first[inverse[::-1]] = idx[::-1]
        if len_3p:
            umi_mat = np.concatenate(
                [uniq_mat[:, :len_5p], uniq_mat[:, ins_hi:]], axis=1)
        else:
            umi_mat = uniq_mat[:, :len_5p]
        inverse_global[idx] = inverse + u_total
        umi_parts.append(umi_mat)
        counts_parts.append(counts)
        gids_parts.append(res_g[2] + gid_offset)
        first_parts.append(first)
        bucket_parts.append(np.full(m, bi, np.int64))
        row_parts.append(np.arange(m, dtype=np.int64))
        per_bucket.append((uniq_mat, ins_lo, ins_hi))
        gid_offset += len(res_g[1])
        u_total += m
    first = np.concatenate(first_parts)
    # Re-rank uniques into global first-occurrence order (dict parity).
    order = np.argsort(first, kind="stable")
    rank = np.empty(u_total, np.int64)
    rank[order] = np.arange(u_total, dtype=np.int64)
    counts = np.concatenate(counts_parts)[order]
    gids = np.concatenate(gids_parts)[order]
    umi_mat = np.ascontiguousarray(np.concatenate(umi_parts)[order])
    bucket_of = np.concatenate(bucket_parts)[order]
    row_of = np.concatenate(row_parts)[order]
    inverse_global = rank[inverse_global]
    lengths = np.full(u_total, umi_len, np.int32)
    words = _pack_validate_matrix(umi_mat, lengths)

    group_sizes = np.bincount(gids)
    candidates = np.flatnonzero(group_sizes[gids] >= 2)
    roots = _cluster_unique(words, lengths, counts, method, threshold,
                            gids=gids, candidates=candidates, block=block,
                            mesh=mesh)
    labels_u, rep_nodes = _relabel(roots, counts)
    molecules = []
    for i in rep_nodes:
        uniq_mat_b, ins_lo, ins_hi = per_bucket[bucket_of[i]]
        row = uniq_mat_b[row_of[i]]
        molecules.append((row[ins_lo:ins_hi].tobytes(),
                          umi_mat[i].tobytes()))
    return labels_u[inverse_global], molecules


def dedup_reads(reads, len_5p: int = 0, len_3p: int = 0,
                threshold: int = 1, method: str = "directional",
                _block=None, mesh=None):
    """Full UMI read deduplication: reads carrying UMIs on the 5'/3' ends
    are grouped by insert sequence, and within each group the UMIs are
    clustered (sequencing-error collapse); each cluster is one original
    molecule.  The standard umi_tools-style dedup workflow, which the
    reference's alpha subpackage was building toward.

    All groups cluster together: adjacency is restricted to keys whose
    insert group holds >= 2 distinct UMIs (singleton groups - the common
    case - do no quadratic work at all), computed in memory-bounded row
    blocks with a group-id mask so edges never cross inserts.

    Args:
      reads: list of str/bytes (UMI(s) still attached), or an [N, L]
        uint8 matrix of uniform-length reads (e.g. straight from
        io.read_fastq_matrix on fixed-length libraries) - the zero-copy
        production path, no per-read Python objects anywhere.
      len_5p/len_3p: UMI lengths clipped from each end.
    Returns:
      (labels, molecules): `labels[i]` is the molecule id of read i;
      `molecules[m]` is `(insert_bytes, umi_bytes)` for molecule m (the
      highest-count UMI of its cluster).
    """
    import collections

    if method not in _METHODS:
        raise ValueError(f"Unknown method: {method}")
    if len_5p < 0 or len_3p < 0:
        raise ValueError("UMI lengths must be non-negative")
    if len_5p + len_3p == 0:
        raise ValueError("at least one UMI length must be positive")
    if len_5p + len_3p > MAX_64_NT:
        raise ValueError("UMIs longer than 32 nt are not supported")
    if len(reads) == 0:
        return np.zeros(0, np.int64), []

    # 2-D arrays are read matrices; 1-D arrays of str/bytes scalars
    # flow through the generic list path below.
    matrix_unavailable = False  # as in dedup_umis: a None from the
    # matrix path means no native library; a retry cannot succeed
    if isinstance(reads, np.ndarray) and reads.ndim == 2:
        if reads.dtype != np.uint8:
            raise TypeError("array input must be a 2-D uint8 read matrix")
        if reads.shape[1] < len_5p + len_3p:
            raise ValueError(
                f"Read of {reads.shape[1]} nt is shorter than the UMI "
                f"lengths ({len_5p} + {len_3p})")
        res = _dedup_reads_matrix(np.ascontiguousarray(reads), len_5p,
                                  len_3p, method, threshold, _block,
                                  mesh=mesh)
        if res is not None:
            return res
        # No native library: fall through via a bytes list.
        matrix_unavailable = True
        reads = [reads[i].tobytes() for i in range(len(reads))]

    norm = [r.encode("ascii") if isinstance(r, str) else bytes(r)
            for r in reads]

    # Vectorized grouping (see _dedup_reads_matrix): unique (insert, UMI)
    # keys ARE unique reads, so native hash-counts with inverse replace
    # the per-read Python split/setdefault/Counter loops (measured
    # ~4 us/read -> ~0.1 us).  Ragged lists take the length-bucketed
    # variant (reads of different lengths never share an insert).  A read
    # shorter than the UMI lengths keeps the Python path so split_read
    # raises its reference error on the FIRST offending read.
    lengths_all = np.fromiter(map(len, norm), np.int64, len(norm))
    if not matrix_unavailable and int(lengths_all.min()) >= len_5p + len_3p:
        lng = int(lengths_all[0])
        if (lengths_all == lng).all():
            res = _dedup_reads_matrix(
                np.frombuffer(b"".join(norm), np.uint8).reshape(
                    len(norm), lng),
                len_5p, len_3p, method, threshold, _block, mesh=mesh)
        else:
            res = _dedup_reads_ragged(norm, lengths_all, len_5p, len_3p,
                                      method, threshold, _block, mesh=mesh)
        if res is not None:
            return res

    gid_of = {}
    inserts = []
    keys = []  # per-read (gid, umi)
    for r in norm:
        u5, insert, u3 = split_read(r, len_5p, len_3p)
        gid = gid_of.setdefault(insert, len(gid_of))
        if gid == len(inserts):
            inserts.append(insert)
        keys.append((gid, u5 + u3))

    counter = collections.Counter(keys)
    uniq = list(counter)
    index = {k: i for i, k in enumerate(uniq)}
    inverse = np.fromiter((index[k] for k in keys), np.int64, len(keys))
    counts = np.fromiter((counter[k] for k in uniq), np.int64, len(uniq))
    gids = np.fromiter((g for g, _ in uniq), np.int64, len(uniq))

    # Validation is uniform: every unique UMI goes through the packed
    # validity check regardless of the collapse path below.
    words, lengths = _pack_validate_umis([u for _, u in uniq])

    # Only keys in multi-key groups can merge; everything else roots itself.
    group_sizes = np.bincount(gids, minlength=len(inserts))
    candidates = np.flatnonzero(group_sizes[gids] >= 2)
    roots = _cluster_unique(words, lengths, counts, method, threshold,
                            gids=gids, candidates=candidates, block=_block,
                            mesh=mesh)
    labels_u, rep_nodes = _relabel(roots, counts)
    molecules = [(inserts[uniq[i][0]], uniq[i][1]) for i in rep_nodes]
    return labels_u[inverse], molecules
