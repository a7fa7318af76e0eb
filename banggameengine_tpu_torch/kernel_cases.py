"""Inputs of the CUDA kernels, for the checks and timings that hold them
to their plain versions.

- :func:`broadphase_edge_cases`, :func:`walk_edge_case` and
  :func:`tile_edge_case`: cases at the edges of the broadphase's, the
  walk's and the full-carry raster's contracts, which the main path's
  inputs rarely reach.  Plain numpy from a seed, so the same arrays feed
  the JAX package, the plain PyTorch versions and the CUDA kernels;
- :func:`box_contact_cases`: the box contact kernel's inputs at the edges
  of its contract (ties, parallel edges, the caps and the budget);
- :func:`solve_contact_case`, :func:`solve_cache_case`: random contact
  solve inputs, ground slots, invalid and full columns among them, and a
  contact cache for them; :func:`unified_solve_case`: the unified solve's
  (contacts in the rows' layout, a cache, random joints);
- :func:`sorted_broadphase_inputs`, :func:`sorted_contact_inputs` and
  :func:`recorded_inputs`: the inputs the main path itself gives the
  kernels;
- :func:`hand_kernels`, :func:`plain_twins`: the registry of the hand
  kernels, and its kernels routed to their plain twins.

``chip_smoke.py``, ``scripts/compare_kernels.py`` and the tests use them;
no entry point of the port does.
"""

from __future__ import annotations

import contextlib
import inspect
import sys

import numpy as np

WALK_LINE_TILE = 3        # the tile whose slot 0 is a zero-area line ...
WALK_LINE_PIXEL = (18, 40)   # ... that covers this (row, column) of it,
# outside its own bounding box


def _filters(rng, n: int):
    dyn = rng.choice(np.array([-1, 0, 1], np.int32), n, p=[0.1, 0.3, 0.6])
    layer = rng.integers(0, 4, n).astype(np.int32)
    mask = np.where(rng.random(n) < 0.5, -1,
                    rng.integers(0, 4, n)).astype(np.int32)
    return dyn, layer, mask


def _random_boxes(rng, n: int, spread: float = 3.0):
    center = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    half = rng.uniform(0.1, 0.8, (n, 3)).astype(np.float32)
    return center - half, center + half


def broadphase_edge_cases(seed: int = 0) -> dict:
    """Broadphase inputs (mn, mx f32[N, 3], dyn, layer, mask int32[N]) by
    name.  The kernel prunes by groups of 32 columns and bands of 64 rows;
    these put the unions at their edges:

    - ``touching``: 231 unit cubes on an integer lattice, x fastest: faces
      meet exactly, so rows touch their neighbours' group unions exactly
      (before the wrapper's margin; the kernel's own inputs, ``lo``/``hi``
      with the margin applied, are these boxes grown, still overlapping);
    - ``nan_inf``: 300 random boxes, some with a NaN bound (one group all
      NaN), some with -inf / +inf bounds, one that spans all space, one
      empty (lo = +inf);
    - ``filter_groups``: 200 random boxes, rows 32..63 not solid, 64..95
      static, 96..127 static with layer 0;
    - ``far_clusters``: 2 x 1,000 boxes along two lines 7 km apart, sorted
      along them: the unions prune almost every (band, group) pair;
    - ``n20``, ``n65``: random boxes, fewer rows than a group, and one more
      than a band.
    """
    rng = np.random.default_rng(seed)
    cases = {}

    g = np.stack(np.meshgrid(np.arange(11), np.arange(7), np.arange(3),
                             indexing="ij"), -1).reshape(-1, 3)
    g = g[np.lexsort((g[:, 0], g[:, 2], g[:, 1]))].astype(np.float32)
    n = g.shape[0]
    cases["touching"] = (g, g + 1.0, np.ones(n, np.int32),
                         np.ones(n, np.int32), np.full(n, -1, np.int32))

    n = 300
    mn, mx = _random_boxes(rng, n)
    nan, inf = np.float32(np.nan), np.float32(np.inf)
    mn[3, 0] = nan
    mx[40, 1] = nan
    mn[41] = nan
    mx[41] = nan
    mn[64:96] = nan                       # a whole group of NaN rows
    mn[100, 0] = -inf
    mx[101, 2] = inf
    mn[102], mx[102] = -inf, inf          # spans all space
    mn[103, 1] = inf                      # empty
    mx[104, 0] = -inf                     # empty
    cases["nan_inf"] = (mn, mx, *_filters(rng, n))

    n = 200
    mn, mx = _random_boxes(rng, n)
    dyn, layer, mask = _filters(rng, n)
    dyn[32:64] = -1
    dyn[64:128] = 0
    layer[96:128] = 0
    cases["filter_groups"] = (mn, mx, dyn, layer, mask)

    n = 1000
    x = np.sort(rng.uniform(0.0, 1000.0, n)).astype(np.float32)
    centers = np.concatenate([
        np.stack([x - 5000.0, rng.uniform(0, 2, n), rng.uniform(0, 2, n)], 1),
        np.stack([x + 3000.0, rng.uniform(0, 2, n), rng.uniform(0, 2, n)], 1),
    ]).astype(np.float32)
    half = rng.uniform(0.3, 0.8, (2 * n, 3)).astype(np.float32)
    cases["far_clusters"] = (centers - half, centers + half,
                             *_filters(rng, 2 * n))

    for n in (20, 65):
        cases[f"n{n}"] = (*_random_boxes(rng, n), *_filters(rng, n))
    return cases


def _quat(axis, angle: float) -> np.ndarray:
    """The unit quaternion (x, y, z, w) of a turn about ``axis``."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    return np.float32([*(axis * np.sin(angle / 2)), np.cos(angle / 2)])


def listed_pairs(pairs, n: int, k: int):
    """Neighbor lists (int32[n, k], -1 padded; bool[n, k]) holding each
    listed pair both ways, in the order given."""
    idx = np.full((n, k), -1, np.int32)
    fill = np.zeros(n, np.int64)
    for a, b in pairs:
        for i, j in ((a, b), (b, a)):
            idx[i, fill[i]] = j
            fill[i] += 1
    return idx, idx >= 0


def box_contact_cases(seed: int = 0) -> dict:
    """Box contact inputs (pos, quat, half f32[N, 3|4|3], nb_idx
    int32[N, K], nb_valid bool[N, K], ground_valid bool[N], orig_id
    int64[N]) by name, for ``contact_t.box_contacts_t``:

    - ``random_k1``, ``_k7``, ``_k8``, ``_k16``: 300 randomly turned boxes
      packed into a 5 m cube that dips below the ground, each listing its
      K nearest others; 15 % of slots -1 padded, 10 % of the rest listed
      but not valid, 20 % of rows off the ground: deep overlaps, pairs
      over the 4-point cap and bodies over a budget of 12;
    - ``resting``: a box resting flat on one of its size (the two face
      axes along y tie; the first, a's, wins), a box resting on a wide
      slab, both grounded: every edge of a pair parallel to one of the
      other's, so 3 of its 9 cross axes are skipped;
    - ``edges``: two boxes turned 45 degrees about z and about x whose
      edges cross (an edge axis wins: slot 16 holds the edges' closest
      points), and two boxes turned alike about y, side by side;
    - ``overflow``: two boxes deep in each other (8 candidates a side), a
      box with 16 partners around it (over the budget), a box under the
      ground (8 ground corners);
    - ``random_k256``, ``random_k257``, ``far_first_k299``: lists as long
      as a block of the kernel (256 pairs) and longer (its wide form,
      which takes a list in chunks of 256), over another 300 boxes like
      the random cases; the last lists every other box farthest first, so
      its contacts lie in the second chunk.
    """
    rng = np.random.default_rng(seed)
    cases = {}
    for k in (1, 7, 8, 16):
        n = 300
        pos = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
        pos[:, 1] += 2.0
        quat = rng.normal(size=(n, 4))
        quat = (quat / np.linalg.norm(quat, axis=1, keepdims=True)).astype(
            np.float32)
        half = rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
        d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        idx = np.argsort(d2, axis=1, kind="stable")[:, :k].astype(np.int32)
        idx[rng.random((n, k)) < 0.15] = -1
        valid = (idx >= 0) & (rng.random((n, k)) >= 0.1)
        cases[f"random_k{k}"] = (pos, quat, half, idx, valid,
                                 rng.random(n) >= 0.2,
                                 rng.permutation(n).astype(np.int64))

    def case(boxes, pairs, k):
        n = len(boxes)
        pos = np.float32([b[0] for b in boxes])
        quat = np.float32([b[1] for b in boxes])
        half = np.float32([b[2] for b in boxes])
        idx, valid = listed_pairs(pairs, n, k)
        return (pos, quat, half, idx, valid, np.ones(n, bool),
                rng.permutation(n).astype(np.int64))

    ident = np.float32([0, 0, 0, 1])
    unit = (1.0, 1.0, 1.0)
    cases["resting"] = case(
        [((0.0, 0.99, 0.0), ident, unit), ((0.0, 2.98, 0.0), ident, unit),
         ((10.0, 0.49, 0.0), ident, (3.0, 0.5, 3.0)),
         ((10.5, 1.98, 0.3), ident, unit)], [(0, 1), (2, 3)], 8)
    r2 = float(np.sqrt(2.0))
    yaw = _quat((0, 1, 0), 0.3)
    cases["edges"] = case(
        [((0.0, 5.0, 0.0), _quat((0, 0, 1), np.pi / 4), unit),
         ((0.1, 5.0 + 2 * r2 - 0.05, 0.2), _quat((1, 0, 0), np.pi / 4),
          unit),
         ((20.0, 1.0, 0.0), yaw, (1.0, 1.0, 0.5)),
         ((20.0 + 1.99 * np.cos(0.3), 1.0, -1.99 * np.sin(0.3)), yaw,
          (1.0, 1.0, 0.5))], [(0, 1), (2, 3)], 8)
    ring = [((40.0 + 1.5 * np.cos(a), 3.0 + 0.3 * np.sin(3 * a),
              1.5 * np.sin(a)), _quat((0, 1, 0), a), (0.8, 0.8, 0.8))
            for a in np.linspace(0.0, 2 * np.pi, 16, endpoint=False)]
    cases["overflow"] = case(
        [((0.0, 5.0, 0.0), ident, unit), ((0.2, 6.5, 0.1), ident, unit),
         ((40.0, 3.0, 0.0), _quat((1, 1, 0), 0.4), (1.2, 1.2, 1.2)),
         *ring, ((-20.0, -2.0, 0.0), _quat((0, 1, 1), 0.2), unit)],
        [(0, 1)] + [(2, 3 + i) for i in range(16)], 16)

    n = 300
    pos = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    pos[:, 1] += 2.0
    quat = rng.normal(size=(n, 4))
    quat = (quat / np.linalg.norm(quat, axis=1, keepdims=True)).astype(
        np.float32)
    half = rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    near = np.argsort(d2, axis=1, kind="stable")[:, :n - 1].astype(np.int32)
    for name, idx in (("random_k256", near[:, :256]),
                      ("random_k257", near[:, :257]),
                      ("far_first_k299", near[:, ::-1])):
        idx = np.ascontiguousarray(idx)
        idx[rng.random(idx.shape) < 0.15] = -1
        valid = (idx >= 0) & (rng.random(idx.shape) >= 0.1)
        cases[name] = (pos, quat, half, idx, valid, rng.random(n) >= 0.2,
                       rng.permutation(n).astype(np.int64))
    return cases


def solve_contact_case(n: int, c: int, seed: int = 0,
                       ground_only: bool = False) -> tuple:
    """Contact solve inputs for ``contact_t.solve_contacts_t``: (vel, ang,
    pos f32[n, 3], quat f32[n, 4], inv_m f32[n], inv_inertia_body
    f32[n, 3], c_prt int32[c, n], c_ptx, c_pty, c_ptz, c_nx, c_ny, c_nz,
    c_dep f32[c, n], c_valid bool[c, n], friction, restitution f32[n],
    dt f32[]), then the warm impulses (ln, lt1, lt2 f32[c, n]).

    Random bodies (10 % static: no inverse mass or inertia) moving at a
    few m/s, so restitution bounces; slots with random partners, a
    quarter of them the ground (-1), contact points within a metre of the
    body, random unit normals (a fifth of them along x, the other tangent
    branch) and depths on both sides of the slop; 70 % of slots valid,
    body 0's column all invalid and body 1's all valid; half the invalid
    slots as the contact kernels fill them (partner -1, zeros), half left
    random; warm normal impulses of both signs.  ``ground_only``: every
    slot the ground, normal +y."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    pos = rng.uniform(-3.0, 3.0, (n, 3)).astype(f32)
    quat = rng.normal(size=(n, 4))
    quat = (quat / np.linalg.norm(quat, axis=1, keepdims=True)).astype(f32)
    vel = (3.0 * rng.normal(size=(n, 3))).astype(f32)
    ang = rng.normal(size=(n, 3)).astype(f32)
    moving = rng.random(n) >= 0.1
    inv_m = np.where(moving, rng.uniform(0.2, 2.0, n), 0.0).astype(f32)
    inertia = np.where(moving[:, None], rng.uniform(0.1, 3.0, (n, 3)),
                       0.0).astype(f32)
    friction = rng.uniform(0.2, 1.0, n).astype(f32)
    restitution = rng.uniform(0.0, 0.6, n).astype(f32)

    prt = rng.integers(0, n, (c, n)).astype(np.int32)
    prt[rng.random((c, n)) < 0.25] = -1
    pt = pos.T[:, None, :] + rng.uniform(-1.0, 1.0, (3, c, n))
    nrm = rng.normal(size=(3, c, n))
    nrm[:, rng.random((c, n)) < 0.2] = np.float64([1.0, 0.1, 0.0])[:, None]
    nrm /= np.linalg.norm(nrm, axis=0, keepdims=True)
    dep = rng.uniform(-0.01, 0.1, (c, n))
    valid = rng.random((c, n)) < 0.7
    valid[:, 0] = False
    if n > 1:
        valid[:, 1] = True
    if ground_only:
        prt[:] = -1
        nrm[:] = np.float64([0.0, 1.0, 0.0])[:, None, None]
    filled = ~valid & (rng.random((c, n)) < 0.5)
    prt[filled] = -1
    pt[:, filled] = 0.0
    nrm[:, filled] = 0.0
    dep[filled] = 0.0
    warm = rng.normal(scale=0.5, size=(3, c, n)).astype(f32)
    return (vel, ang, pos, quat, inv_m, inertia, prt, *pt.astype(f32),
            *nrm.astype(f32), dep.astype(f32), valid, friction, restitution,
            f32(1.0 / 120.0), *warm)


def solve_cache_case(n: int, c: int, cb: int, seed: int = 0,
                     unique: bool = True) -> tuple:
    """A contact cache for :func:`solve_contact_case`'s slots: this step's
    feature ids (c_feat int32[c, n]) and the cache as the state keeps it
    (contact_feat int32[n, cb], contact_imp f32[n, cb, 3]).  Ids are drawn
    from -1..23, so about half the slots find their id among the cached
    ones; a body's cached ids are unique, as the step keeps them, but for
    its empty slots (-1), which never match.  ``unique=False``: the cached
    ids are drawn from 0..5 with repeats, so a matched id matches a few
    cached slots at once."""
    rng = np.random.default_rng(seed)
    c_feat = rng.integers(-1, 24, (c, n)).astype(np.int32)
    if unique:
        feat = np.stack([rng.permutation(24)[:cb] for _ in range(n)])
    else:
        c_feat = np.where(c_feat >= 0, c_feat % 6, -1).astype(np.int32)
        feat = rng.integers(0, 6, (n, cb))
    feat[rng.random((n, cb)) < 0.2] = -1
    imp = rng.normal(scale=0.5, size=(n, cb, 3)).astype(np.float32)
    return c_feat, feat.astype(np.int32), imp


def unified_solve_case(n: int, c: int, seed: int = 0, joints: int = 0,
                       cache_width: int = 12) -> dict:
    """Inputs of ``unified_kernel.solve_unified`` as numpy arrays:
    ``args``, its 14 leading positional arguments (v, w, pos f32[n, 3],
    quat f32[n, 4], inv_m f32[n], inv_inertia_body f32[n, 3], friction,
    restitution f32[n], c_b int32[n, c], c_point, c_normal f32[n, c, 3],
    c_depth f32[n, c], c_valid bool[n, c], dt f32[]); ``cache`` (c_feat
    int32[n, c], contact_feat int32[n, cache_width], contact_imp f32[n,
    cache_width, 3]); ``alive`` bool[n]; and with ``joints`` J > 0
    ``table``, the keyword arguments of ``joints.make_joint_set`` but
    ``capacity`` and ``mass_splitting``, and ``impulse`` f32[J, 7].

    Random bodies as :func:`solve_contact_case` draws them (10 % static,
    moving at a few m/s), a tenth of them dead, the last among them; slots
    in the rows' layout, a quarter of the partners the ground, 70 % valid,
    body 0's row all invalid and body 1's all valid, half the invalid
    slots as the compaction fills them (partner -1, zeros); cached ids
    drawn from -1..23, unique within a row but for -1.  Joint k joins the
    k-th moving body (mod their count) to another moving body drawn at
    random, half hinges and half cone-twists, random frames and anchors
    within half a metre, and limits around the random poses' angles, so
    that limit, swing and twist rows come out both on and off; last step's
    impulses of both signs."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def unit_quats(m):
        q = rng.normal(size=(m, 4))
        return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(f32)

    pos = rng.uniform(-3.0, 3.0, (n, 3)).astype(f32)
    quat = unit_quats(n)
    vel = (3.0 * rng.normal(size=(n, 3))).astype(f32)
    ang = rng.normal(size=(n, 3)).astype(f32)
    moving = rng.random(n) >= 0.1
    inv_m = np.where(moving, rng.uniform(0.2, 2.0, n), 0.0).astype(f32)
    inertia = np.where(moving[:, None], rng.uniform(0.1, 3.0, (n, 3)),
                       0.0).astype(f32)
    friction = rng.uniform(0.2, 1.0, n).astype(f32)
    restitution = rng.uniform(0.0, 0.6, n).astype(f32)
    alive = rng.random(n) >= 0.1
    alive[-1] = n < 3         # a dead body in every case of 3 or more

    prt = rng.integers(0, n, (n, c)).astype(np.int32)
    prt[rng.random((n, c)) < 0.25] = -1
    pt = pos[:, None, :] + rng.uniform(-1.0, 1.0, (n, c, 3))
    nrm = rng.normal(size=(n, c, 3))
    nrm[rng.random((n, c)) < 0.2] = np.float64([1.0, 0.1, 0.0])
    nrm /= np.linalg.norm(nrm, axis=2, keepdims=True)
    dep = rng.uniform(-0.01, 0.1, (n, c))
    valid = rng.random((n, c)) < 0.7
    valid[0] = False
    if n > 1:
        valid[1] = True
    filled = ~valid & (rng.random((n, c)) < 0.5)
    prt[filled] = -1
    pt[filled] = 0.0
    nrm[filled] = 0.0
    dep[filled] = 0.0
    c_feat = rng.integers(-1, 24, (n, c)).astype(np.int32)
    feat = np.stack([rng.permutation(24)[:cache_width] for _ in range(n)])
    feat[rng.random((n, cache_width)) < 0.2] = -1
    imp = rng.normal(scale=0.5, size=(n, cache_width, 3)).astype(f32)
    out = dict(args=(vel, ang, pos, quat, inv_m, inertia, friction,
                     restitution, prt, pt.astype(f32), nrm.astype(f32),
                     dep.astype(f32), valid, f32(1.0 / 120.0)),
               cache=(c_feat, feat.astype(np.int32), imp),
               alive=alive)
    if joints:
        # joints between moving bodies (two static ones have no effective
        # mass to invert)
        movers = np.flatnonzero(moving)
        m = len(movers)
        ka = np.arange(joints) % m
        a = movers[ka]
        b = movers[(ka + rng.integers(1, m, joints)) % m]
        kind = (rng.random(joints) < 0.5).astype(np.int8)

        def frames():
            q = unit_quats(joints).astype(np.float64)
            x, y, z, w = q.T
            return np.stack([
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x),
                 1 - 2 * (x * x + y * y)]]).transpose(2, 0, 1).astype(f32)

        hinge = kind == 0
        lo = np.where(hinge, -rng.uniform(0.0, 2.0, joints),
                      rng.uniform(0.2, 2.0, joints)).astype(f32)
        hi = np.where(hinge, rng.uniform(0.0, 2.0, joints),
                      rng.uniform(0.2, 2.5, joints)).astype(f32)
        out["table"] = dict(
            body_a=a.astype(np.int32), body_b=b.astype(np.int32), kind=kind,
            origin_a=rng.uniform(-0.5, 0.5, (joints, 3)).astype(f32),
            origin_b=rng.uniform(-0.5, 0.5, (joints, 3)).astype(f32),
            basis_a=frames(), basis_b=frames(), limit_lo=lo, limit_hi=hi)
        out["impulse"] = rng.normal(scale=0.5, size=(joints, 7)).astype(f32)
    return out


def unified_solve_tensors(case: dict, device,
                          mass_splitting: bool = False) -> dict:
    """:func:`unified_solve_case`'s arrays as tensors on ``device``: the
    same keys, with ``joints`` (a ``joints.JointSet`` of ``mass_splitting``,
    or None) and ``joint_state`` in place of ``table`` and ``impulse``."""
    import torch

    from banggameengine_tpu_torch.physics import joints as jt

    def t(x):
        return torch.as_tensor(x, device=device)

    out = dict(args=tuple(t(x) for x in case["args"]),
               cache=tuple(t(x) for x in case["cache"]),
               alive=t(case["alive"]), joints=None, joint_state=None)
    if "table" in case:
        out["joints"] = jt.make_joint_set(
            len(case["alive"]), **case["table"],
            mass_splitting=mass_splitting, device=device)
        out["joint_state"] = jt.JointState(
            impulse=t(case["impulse"]),
            limit_rows=torch.zeros((), dtype=torch.int32, device=device))
    return out


def walk_edge_case(n_tiles: int = 13, k_pad: int = 272, tiles_x: int = 5,
                   seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Walk inputs (counts int32[n_tiles], tri_pack f32[n_tiles, k_pad,
    16]) full of rows at the coverage rule's edges: zero-area rows
    (collinear corners, a repeated corner, all three the same), corners
    exactly on pixel centres, zero-area and half-pixel slivers along a
    pixel row, triangles far larger than the tile, the same triangle in two
    slots (a depth tie), depths outside [0, 1] and rows marked unused
    inside the count.  Tiles 0, 1 and 2 walk 0, 1 and ``k_pad`` slots, the
    rest random counts; 13 tiles is no multiple of a tile's bands.

    Every corner is an integer or a pixel centre within ~1,600 pixels and
    every depth a power of two or 0, so each edge function is exact in
    f32 and each depth rounds the same with or without fused
    multiply-adds: the JAX package on the CPU agrees exactly.  The
    zero-area line in slot 0 of tile :data:`WALK_LINE_TILE` is nearest
    (depth 0) and covers :data:`WALK_LINE_PIXEL`, outside its bounding
    box."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, k_pad + 1, n_tiles).astype(np.int32)
    counts[:3] = (0, 1, k_pad)
    counts[WALK_LINE_TILE] = max(counts[WALK_LINE_TILE], 1)
    pack = np.zeros((n_tiles, k_pad, 16), np.float32)
    zs = np.float32([0.0, 0.125, 0.25, 0.5, 1.0, 2.0, -0.5])
    for t in range(n_tiles):
        ox, oy = (t % tiles_x) * 128.0, (t // tiles_x) * 32.0
        c = lambda x, y: (ox + x, oy + y)  # noqa: E731
        special = [
            (c(10.5, 3.5), c(20.5, 8.5), c(30.5, 13.5)),     # collinear
            (c(12.5, 4.5), c(12.5, 4.5), c(50.5, 20.5)),     # repeated
            (c(64.5, 16.5), c(64.5, 16.5), c(64.5, 16.5)),   # a point
            (c(5.5, 2.5), c(60.5, 2.5), c(5.5, 30.5)),       # on centres
            (c(60.5, 2.5), c(5.5, 2.5), c(5.5, 30.5)),       # the same, cw
            (c(0.5, 7.5), c(127.5, 7.5), c(64.5, 7.5)),      # row sliver
            (c(0.5, 9.5), c(127.5, 9.5), c(64.5, 10.0)),     # half-pixel
            (c(-1000, -500), c(1500, -400), c(50, 1100)),    # huge
            (c(1400, 1000), c(-900, 1100), c(100, -600)),    # huge, cw
            (c(20, 0), c(100, 31), c(-30, 40)),
        ]
        rows = []
        for s in range(k_pad):
            if s < len(special):
                (x0, y0), (x1, y1), (x2, y2) = special[s]
            elif s % 17 == 0:               # a copy of an earlier row
                rows.append(rows[int(rng.integers(0, len(rows)))])
                continue
            else:
                cx, cy = rng.integers(-20, 148), rng.integers(-10, 42)
                (x0, x1, x2) = cx + rng.integers(-40, 41, 3) + ox
                (y0, y1, y2) = cy + rng.integers(-20, 21, 3) + oy
            z = rng.choice(zs, 3)
            if t == WALK_LINE_TILE and s == 0:
                z[:] = 0.0
            rows.append((x0, x1, x2, y0, y1, y2, *z))
        pack[t, :, :9] = np.asarray(rows, np.float32)
    pack[..., 9] = np.arange(k_pad)[None, :] < counts[:, None]
    pack[:, 11::23, 9] = 0.0                # unused rows inside the count
    return counts, pack


def tile_edge_case(seed: int = 0) -> tuple:
    """Full-carry raster inputs (tile_idx int32[13], x, y, z f32[13, 272,
    3], oid int32[13, 272], cb1, cb2 f32[13, 272, 3], ok int32[13, 272],
    tiles_x) with the rows of :func:`walk_edge_case`: each screen tile's
    rows, over that tile, listed in a shuffled order, ok set where the
    walk's pack marks a row used (rows past its count are unused), random
    ids, and random barycentric columns of 0 and powers of two, so each
    winner's barycentrics are exact in f32 too and the JAX package on the
    CPU agrees exactly.  Screen tile :data:`WALK_LINE_TILE` keeps its
    zero-area line in slot 0."""
    counts, pack = walk_edge_case()
    rng = np.random.default_rng(seed)
    n, k = pack.shape[:2]
    order = rng.permutation(n)
    rows = pack[order]
    cols = np.float32([0.0, 0.125, 0.25, 0.5, 1.0])
    return (order.astype(np.int32), rows[..., 0:3].copy(),
            rows[..., 3:6].copy(), rows[..., 6:9].copy(),
            rng.integers(0, 10**6, (n, k)).astype(np.int32),
            rng.choice(cols, (n, k, 3)), rng.choice(cols, (n, k, 3)),
            (rows[..., 9] > 0).astype(np.int32), 5)


def carry_pack(x, y, z, ok):
    """The full-carry raster's rows (x, y, z f32[n, K, 3], ok int[n, K]) as
    the walk's packed rows f32[n, K, 16], for ``raster_walk.cover_boxes``
    and the skip shares: the boxes the tile raster skips by are those of
    this pack."""
    import torch

    pack = torch.zeros(tuple(ok.shape) + (16,), dtype=torch.float32,
                       device=ok.device)
    pack[..., 0:3], pack[..., 3:6], pack[..., 6:9] = x, y, z
    pack[..., 9] = (ok != 0).to(torch.float32)
    return pack


def sorted_broadphase_inputs(state, static):
    """The broadphase inputs of one stress step, in Morton order, as
    ``physics_step`` builds them: (mn, mx, dyn, layer, mask)."""
    import torch

    from banggameengine_tpu_torch.physics import shapes
    from banggameengine_tpu_torch.physics.broadphase_kernel import (
        morton_key_xz)
    from banggameengine_tpu_torch.state import (
        BODY_DYNAMIC, COMP_CHARACTER, COMP_COLLIDER)

    order = torch.argsort(morton_key_xz(state.pos), stable=True)
    mn, mx = shapes.shape_aabb(state.pos, state.quat, static.shape_type,
                               static.shape_size)
    alive = state.alive
    solid = alive & ((state.comp_mask & COMP_COLLIDER) != 0) & (
        (state.comp_mask & COMP_CHARACTER) == 0)
    is_dyn = (static.body_type == BODY_DYNAMIC) & alive
    dyn = torch.where(solid, is_dyn.to(torch.int32), -1)
    return (mn[order], mx[order], dyn[order], static.layer[order],
            static.mask[order])


def sorted_contact_inputs(state, static, k: int = 8):
    """The box contact inputs of one stress step, in Morton order, as the
    all-pairs route builds them (the broadphase kernel's lists on the
    card, its plain version on the CPU): (pos, quat, half, nb_idx,
    nb_valid, ground_valid, order)."""
    import torch

    from banggameengine_tpu_torch.physics import broadphase_kernel as bk

    mn, mx, dyn, layer, mask = sorted_broadphase_inputs(state, static)
    order = torch.argsort(bk.morton_key_xz(state.pos), stable=True)
    nl = bk.neighbor_lists_aabb(mn, mx, dyn, layer, mask, max_neighbors=k)
    return (state.pos[order], state.quat[order], static.shape_size[order],
            nl.idx, nl.valid, dyn > 0, order)


def hand_kernels() -> dict:
    """The registry (``cuda_build.KERNELS``) with every hand kernel in it:
    the modules that launch them imported (the step, the frame and the
    shade-parts probe)."""
    import banggameengine_tpu_torch.engine  # noqa: F401
    import banggameengine_tpu_torch.render.pipeline  # noqa: F401
    import banggameengine_tpu_torch.scripts.profile_shade_parts  # noqa: F401
    from banggameengine_tpu_torch.cuda_build import KERNELS

    return KERNELS


@contextlib.contextmanager
def _wrappers_replaced(keys, make):
    """Inside, the wrapper of each hand kernel of ``keys`` (all of them
    when empty) is ``make(kernel)`` in its module, where the main path
    looks it up, and the factories run eagerly (:func:`graphs.eager`), so
    no captured graph replays the kernels."""
    from banggameengine_tpu_torch import graphs

    kernels = hand_kernels()
    saved = []
    for key in keys or tuple(kernels):
        k = kernels[key]
        mod = sys.modules[k.wrapper.__module__]
        name = k.wrapper.__name__
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, make(k))
    try:
        with graphs.eager():
            yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def plain_twins(*keys):
    """Route the hand kernels ``keys`` (all of them when none is given)
    to their plain twins inside, eagerly: the comparison runs of the card's
    checks."""
    return _wrappers_replaced(keys, lambda k: k.plain)


@contextlib.contextmanager
def recorded_inputs(*keys):
    """Record the arguments of every call of the hand kernels ``keys``
    (all of them when none is given) made inside: the inputs the main path
    gives the kernels, ``{key: [positional arguments of each call]}``,
    defaults filled in.  The kernels still run, eagerly, so every call is
    recorded once, with the values it ran on."""
    rec = {}

    def recorder(k):
        sig = inspect.signature(k.wrapper)
        calls = rec.setdefault(k.key, [])

        def run(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            calls.append(bound.args)
            return k.wrapper(*args, **kwargs)
        return run

    with _wrappers_replaced(keys, recorder):
        yield rec
