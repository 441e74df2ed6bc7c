"""Plain reference of PQ3D stage 1 (instance segmentation) as served.

Written from the model's equations in plain numpy and torch, one scene at
a time, with no padding, no caps and no batching; it imports nothing of
the port.  Weights are read from a state dict under the port's parameter
names (the checkpoint layout both sides load).

- host pipeline: 2 cm voxels (first point of a voxel represents it,
  voxels in lexicographic coordinate order), colours normalised, segment
  centres, 120 queries by farthest-point sampling (from voxel 0, first
  maximum) over the candidate subset the server's generator drew;
- Res16UNet34C: the 5^3 stem, four stride-2 down convs and residual
  stages, four transpose convs with skip concatenation; every sparse conv
  multiplies bf16-rounded operands and accumulates in f32, and the stem's
  output is rounded to bf16 (the precision the configuration states for
  the sparse convs); batch norm with running statistics (eval);
- segment pooling of each decoder scale onto the over-segmentation, and
  a Linear + LayerNorm projection per scale;
- the query decoder: per round the mask head, then cross attention to
  the voxel, mv and pc memories in parallel (with the extra zero key
  slot), spatial self-attention over the queries' pairwise geometry and
  the FFN;
- the ranking of one scene's final logits into scored instance masks at
  full point resolution.

``forward_scene`` runs the decoder forced: each round's attend mask is
formed from the mask logits that the judged program gave in that round
(``forced``), as a served language model is judged on its own tokens.
Everything else is computed from the scene and the weights alone.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

COLOR_MEAN = np.array([0.47793125906962, 0.4303257521323044,
                       0.3749598901421883], np.float32)
COLOR_STD = np.array([0.2834475483823543, 0.27566157565723015,
                      0.27018971370874995], np.float32)
LN_EPS = 1e-6          # every LayerNorm but the class head's
HEAD_LN_EPS = 1e-12    # the class head's MLP
BN_EPS = 1e-5
NEG_INF = -1e9
BACKBONE = "voxel_encoder.backbone."


# ---------------------------------------------------------------- host side

def voxelize(points: np.ndarray, voxel_size: float):
    """(voxel coords (V, 3) int64 in lexicographic order, the index of
    each voxel's first point, each point's voxel)."""
    grid = np.floor(points / np.float32(voxel_size)).astype(np.int64)
    g = grid - grid.min(0)
    dims = g.max(0) + 1
    key = (g[:, 0] * dims[1] + g[:, 1]) * dims[2] + g[:, 2]
    _, first, inverse = np.unique(key, return_index=True,
                                  return_inverse=True)
    return grid[first], first, inverse


def fps(points: np.ndarray, n: int) -> np.ndarray:
    """Farthest-point sampling from point 0; ties go to the lowest
    index."""
    pts = points.astype(np.float32)
    mind = np.full(len(pts), np.inf, np.float32)
    picks = np.empty(n, np.int64)
    last = 0
    for i in range(n):
        picks[i] = last
        d = ((pts - pts[last]) ** 2).sum(-1)
        np.minimum(mind, d, out=mind)
        last = int(np.argmax(mind))
    return picks


def query_candidates(n_voxels: Sequence[int], subsample: int,
                     num_queries: int, seed: int = 0):
    """The candidate subsets the serving host draws, request by request in
    the order it preprocesses them: one ``choice(n, subsample,
    replace=False)`` from ``default_rng(seed)`` per scene with more than
    ``subsample`` voxels, none (every voxel a candidate) otherwise."""
    rng = np.random.default_rng(seed)
    for n in n_voxels:
        if subsample and n > subsample >= num_queries:
            yield rng.choice(n, size=subsample, replace=False)
        else:
            yield None


def prepare_scene(scene: Dict[str, np.ndarray], voxel_size: float,
                  num_queries: int, max_segments: int,
                  candidates: Optional[np.ndarray]) -> Dict:
    """One scan -> the model's inputs (unpadded)."""
    points = scene["points"].astype(np.float32)
    colors = scene["colors"].astype(np.float32)
    seg = scene["segment_id"].astype(np.int64)
    n_seg = int(seg.max()) + 1
    cnt = np.maximum(np.bincount(seg, minlength=n_seg), 1)
    center = np.stack([np.bincount(seg, weights=points[:, c],
                                   minlength=n_seg) for c in range(3)], 1)
    center = (center / cnt[:, None]).astype(np.float32)
    coords, first, _ = voxelize(points, voxel_size)
    color_n = ((colors + 1) / 2 - COLOR_MEAN) / COLOR_STD
    vox_pts = points[first]
    if candidates is None:
        picks = fps(coords.astype(np.float32), num_queries)
    else:
        picks = candidates[fps(coords[candidates].astype(np.float32),
                               num_queries)]
    S = max_segments
    seg_center = np.zeros((S, 3), np.float32)
    seg_center[:min(n_seg, S)] = center[:S]
    return {"coords": coords, "feats": color_n[first],
            "v2s": seg[first], "n_seg": min(n_seg, S),
            "seg_center": seg_center, "query_locs": vox_pts[picks],
            "coord_min": points.min(0), "coord_max": points.max(0),
            "seg_to_full": seg}


def voxel_inputs(scene: Dict[str, np.ndarray], voxel_size: float):
    """(voxel coords, normalised colours, segment id) of each voxel."""
    coords, first, _ = voxelize(scene["points"].astype(np.float32),
                                voxel_size)
    colors = scene["colors"].astype(np.float32)[first]
    return (coords, ((colors + 1) / 2 - COLOR_MEAN) / COLOR_STD,
            scene["segment_id"].astype(np.int64)[first])


def n_voxels(scene: Dict[str, np.ndarray], voxel_size: float) -> int:
    return len(voxelize(scene["points"].astype(np.float32),
                        voxel_size)[0])


# ------------------------------------------------------------ sparse U-Net

def _offsets(k: int, device) -> torch.Tensor:
    r = torch.arange(-(k // 2), k // 2 + 1, device=device)
    g = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([t.reshape(-1) for t in g], 1)   # z fastest


class Level:
    """One level's coordinates with a lookup of coordinate -> row."""

    def __init__(self, coords: torch.Tensor):
        self.coords = coords
        self.lo = coords.min(0).values - 3
        self.dims = coords.max(0).values - self.lo + 4
        self.keys = self.key(coords)
        assert bool((self.keys[1:] > self.keys[:-1]).all())

    def key(self, c: torch.Tensor) -> torch.Tensor:
        s = c - self.lo
        return (s[..., 0] * self.dims[1] + s[..., 1]) * self.dims[2] \
            + s[..., 2]

    def lookup(self, c: torch.Tensor) -> torch.Tensor:
        """Row of each coordinate in ``c``, -1 where absent."""
        inside = ((c >= self.lo) & (c < self.lo + self.dims)).all(-1)
        k = self.key(c)
        pos = torch.searchsorted(self.keys, k).clamp_max(len(self.keys) - 1)
        return torch.where(inside & (self.keys[pos] == k), pos, -1)

    def neighbours(self, k: int) -> torch.Tensor:
        """(N, k^3) rows of coord + offset, -1 where absent."""
        off = _offsets(k, self.coords.device)
        return self.lookup(self.coords[:, None, :] + off[None])


def hierarchy(coords0: torch.Tensor, levels: int = 5):
    """Levels 0..levels-1 (each the previous one's voxels halved), and
    for each step the fine rows' parent row and child offset
    (x * 4 + y * 2 + z of the remainder)."""
    lv = [Level(coords0)]
    parent, off = [], []
    for _ in range(levels - 1):
        c = lv[-1].coords
        half = torch.div(c, 2, rounding_mode="floor")
        coarse = torch.unique(half, dim=0)     # lexicographic
        nxt = Level(coarse)
        parent.append(nxt.lookup(half))
        r = c - 2 * half
        off.append(r[:, 0] * 4 + r[:, 1] * 2 + r[:, 2])
        lv.append(nxt)
    return lv, parent, off


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def conv(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor
         ) -> torch.Tensor:
    """out[j] = sum_k x[nbr[j, k]] @ w[k], bf16 operands, f32 sums."""
    xb, wb = bf16(x), bf16(w)
    out = torch.zeros(nbr.shape[0], w.shape[2], device=x.device)
    for k in range(nbr.shape[1]):
        idx = nbr[:, k]
        has = idx >= 0
        if has.any():
            out[has] += xb[idx[has]] @ wb[k]
    return out


def down(x: torch.Tensor, parent: torch.Tensor, off: torch.Tensor,
         n_coarse: int, w: torch.Tensor) -> torch.Tensor:
    """Stride-2 conv: each coarse voxel sums its children's rows times the
    kernel tap of their offset."""
    xb, wb = bf16(x), bf16(w)
    out = torch.zeros(n_coarse, w.shape[2], device=x.device)
    for k in range(8):
        sel = off == k
        out.index_add_(0, parent[sel], xb[sel] @ wb[k])
    return out


def up(x: torch.Tensor, parent: torch.Tensor, off: torch.Tensor,
       w: torch.Tensor) -> torch.Tensor:
    """Stride-2 transpose conv: each fine voxel takes its parent's row
    times the kernel tap of its offset."""
    xb, wb = bf16(x), bf16(w)
    out = torch.zeros(len(parent), w.shape[2], device=x.device)
    for k in range(8):
        sel = off == k
        out[sel] = xb[parent[sel]] @ wb[k]
    return out


def bn(sd: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return ((x - sd[name + ".mean"]) * torch.rsqrt(sd[name + ".var"] + BN_EPS)
            * sd[name + ".scale"] + sd[name + ".bias"])


def basic_block(sd: Dict, name: str, x: torch.Tensor, nbr: torch.Tensor
                ) -> torch.Tensor:
    out = F.relu(bn(sd, name + ".norm1", conv(x, nbr,
                                               sd[name + ".conv1.kernel"])))
    out = bn(sd, name + ".norm2", conv(out, nbr, sd[name + ".conv2.kernel"]))
    res = x
    if name + ".downsample_conv.weight" in sd:
        res = bn(sd, name + ".downsample_norm",
                 x @ sd[name + ".downsample_conv.weight"].T)
    return F.relu(out + res)


def stage(sd: Dict, name: str, x: torch.Tensor, nbr: torch.Tensor
          ) -> torch.Tensor:
    i = 0
    while f"{name}.block{i}.conv1.kernel" in sd:
        x = basic_block(sd, f"{name}.block{i}", x, nbr)
        i += 1
    return x


def backbone(sd: Dict, feats: torch.Tensor, coords: torch.Tensor):
    """Feature maps [L4, L3, L2, L1, L0] of one scene, and the hierarchy
    (levels, parents, offsets)."""
    b = BACKBONE
    lv, parent, off = hierarchy(coords)
    w0 = sd[b + "conv0.kernel"]
    k0 = round(w0.shape[0] ** (1 / 3))
    out = bf16(conv(feats, lv[0].neighbours(k0), w0))
    out = F.relu(bn(sd, b + "bn0", out))
    nbr3 = [level.neighbours(3) for level in lv]
    skips = [out]
    for l in range(4):
        out = down(out, parent[l], off[l], len(lv[l + 1].coords),
                   sd[b + f"conv{l + 1}s2.kernel"])
        out = F.relu(bn(sd, b + f"bn{l + 1}", out))
        out = stage(sd, b + f"stage{l + 1}", out, nbr3[l + 1])
        skips.append(out)
    maps = [out]
    for i in range(4):
        lvl = 3 - i
        out = up(out, parent[lvl], off[lvl], sd[b + f"convtr{i + 4}.kernel"])
        out = F.relu(bn(sd, b + f"bntr{i + 4}", out))
        out = torch.cat([out, skips[lvl]], -1)
        out = stage(sd, b + f"stage{i + 5}", out, nbr3[lvl])
        maps.append(out)
    return maps, parent


# ------------------------------------------------------------- the decoder

def linear(sd: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
    y = x @ sd[name + ".weight"].T
    if name + ".bias" in sd:
        y = y + sd[name + ".bias"]
    return y


def layer_norm(sd: Dict, name: str, x: torch.Tensor, eps: float = LN_EPS
               ) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], sd[name + ".weight"],
                        sd[name + ".bias"], eps)


def coord_embed(sd: Dict, xyz: torch.Tensor, lo: torch.Tensor,
                hi: torch.Tensor) -> torch.Tensor:
    """Gaussian Fourier features of the coordinates scaled to the scene's
    box, then Linear + LayerNorm."""
    x = (xyz - lo) / (hi - lo).clamp_min(1e-6) * (2 * math.pi)
    proj = x @ sd["coord_encoder.pos_enc.gauss_B"]
    pe = torch.cat([torch.sin(proj), torch.cos(proj)], -1)
    return layer_norm(sd, "coord_encoder.LayerNorm_0",
                      linear(sd, "coord_encoder.Dense_0", pe))


def heads(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.reshape(x.shape[0], n, -1).transpose(0, 1)     # (h, L, dk)


def cross_attention(sd: Dict, name: str, n_head: int, query, qpos, mem,
                    mpos, attend) -> torch.Tensor:
    """Post-norm residual attention of the queries over one memory, with
    an extra key of logit 0 whose weight is dropped."""
    a = name + ".MultiHeadAttention_0."
    q = heads(linear(sd, a + "q_proj", query + qpos), n_head)
    k = heads(linear(sd, a + "k_proj", mem + mpos), n_head)
    v = heads(linear(sd, a + "v_proj", mem), n_head)
    logits = q @ k.transpose(1, 2) / math.sqrt(q.shape[-1])
    logits = torch.where(attend[None], logits, NEG_INF)
    logits = torch.cat([logits, logits.new_zeros(logits.shape[:-1] + (1,))],
                       -1)
    p = torch.softmax(logits, -1)[..., :-1]
    out = (p @ v).transpose(0, 1).reshape(query.shape)
    return layer_norm(sd, name + ".LayerNorm_0",
                      query + linear(sd, a + "out_proj", out))


def pairwise_center(c: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """(L, L, 5): distance over the largest, the vertical sine, the
    horizontal cosine and the two planar direction cosines."""
    rel = c[:, None, :] - c[None, :, :]
    dist = torch.sqrt((rel ** 2).sum(-1) + eps)
    d2 = torch.sqrt((rel[..., :2] ** 2).sum(-1) + eps)
    return torch.stack([dist / dist.max(), rel[..., 2] / dist, d2 / dist,
                        rel[..., 1] / d2, rel[..., 0] / d2], -1)


def spatial_self_attention(sd: Dict, name: str, n_head: int, query, qpos,
                           pairwise) -> torch.Tensor:
    a = name + ".MultiHeadAttentionSpatial_0."
    qk = query + qpos
    q = heads(linear(sd, a + "w_qs", qk), n_head)
    k = heads(linear(sd, a + "w_ks", qk), n_head)
    v = heads(linear(sd, a + "w_vs", query), n_head)
    attn = q @ k.transpose(1, 2) / math.sqrt(q.shape[-1])
    loc = F.relu(linear(sd, a + "pairwise_loc_fc", pairwise)).permute(2, 0, 1)
    w = torch.softmax(torch.log(loc.clamp_min(1e-6)) + attn, -1)
    out = (w @ v).transpose(0, 1).reshape(query.shape)
    return layer_norm(sd, name + ".LayerNorm_0",
                      query + linear(sd, a + "fc", out))


def ffn(sd: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
    h = F.relu(linear(sd, name + ".Dense_0", x))
    return layer_norm(sd, name + ".LayerNorm_0",
                      x + linear(sd, name + ".Dense_1", h))


def mask_head(sd: Dict, query, match, seg_valid, filtered):
    """(class logits (Q, T), mask logits (S, Q))."""
    h = layer_norm(sd, "mask_head.cls_head.LayerNorm_0",
                   F.relu(linear(sd, "mask_head.cls_head.Dense_0", query)),
                   HEAD_LN_EPS)
    cls = linear(sd, "mask_head.cls_head.Dense_1", h)
    cls[:, filtered] = NEG_INF
    total = 0.0
    for i, feat in enumerate(match):
        p = f"mask_head.mask_pred_{i}."
        total = total + linear(sd, p + "k_proj", feat) \
            @ linear(sd, p + "q_proj", query).T
    mask = total / (len(match) + 1e-8)
    mask = torch.where(seg_valid[:, None], mask, -1e6)
    return cls, mask


def pooled_segments(maps, parent, v2s: torch.Tensor, S: int,
                    hlevels: Sequence[int]):
    """(each scale's mean over every level-0 voxel of a segment of its
    ancestor's feature, (S, C) with segments past ``S`` dropped, and the
    voxels of each segment)."""
    keep = v2s < S
    seg = v2s[keep]
    count = torch.bincount(seg, minlength=S)
    n_s = count.clamp_min(1).float()[:, None]
    out = []
    for h in list(hlevels) + [4]:
        rows = torch.arange(len(v2s), device=v2s.device)
        for l in range(4 - h):
            rows = parent[l][rows]
        f = maps[h][rows][keep]
        pooled = torch.zeros(S, f.shape[1], device=f.device)
        pooled.index_add_(0, seg, f)
        out.append(pooled / n_s)
    return out, count


def segment_features(sd: Dict, maps, parent, v2s: torch.Tensor, S: int,
                     hlevels: Sequence[int]) -> List[torch.Tensor]:
    """Each scale's pooled segment features, projected."""
    pooled, _ = pooled_segments(maps, parent, v2s, S, hlevels)
    out = []
    for i, x in enumerate(pooled):
        p = f"voxel_encoder.feat_proj_{i}."
        out.append(layer_norm(sd, p + "LayerNorm_0",
                              linear(sd, p + "Dense_0", x)))
    return out


def attend_from(mask_logits: torch.Tensor) -> torch.Tensor:
    """(Q, S) attend bits of a round's mask logits (S, Q): sigmoid >= 0.5,
    a query that attends nowhere attends everywhere."""
    att = torch.sigmoid(mask_logits.float()).T >= 0.5
    return att | ~att.any(-1, keepdim=True)


def forward_scene(sd: Dict, prep: Dict, arch: Dict,
                  forced: Sequence[torch.Tensor], device) -> Dict:
    """Every round's (class, mask) logits of one scene; round r's attend
    mask comes from ``forced[r]`` (that round's judged mask logits, (S, Q))
    for r < rounds - 1."""
    S, H = arch["max_segments"], arch["num_heads"]
    f32 = dict(dtype=torch.float32, device=device)
    coords = torch.as_tensor(prep["coords"], device=device)
    feats = torch.as_tensor(prep["feats"], **f32)
    v2s = torch.as_tensor(prep["v2s"], device=device)
    maps, parent = backbone(sd, feats, coords)
    scales = segment_features(sd, maps, parent, v2s, S, arch["hlevels"])
    lo = torch.as_tensor(prep["coord_min"], **f32)
    hi = torch.as_tensor(prep["coord_max"], **f32)
    qlocs = torch.as_tensor(prep["query_locs"], **f32)
    qpos = coord_embed(sd, qlocs, lo, hi)
    mpos = coord_embed(sd, torch.as_tensor(prep["seg_center"], **f32), lo, hi)
    seg_valid = torch.arange(S, device=device) < prep["n_seg"]
    zeros = torch.zeros(S, arch["mv_dim"], **f32)
    obj = {m: layer_norm(sd, f"{m}_encoder.LayerNorm_0",
                         linear(sd, f"{m}_encoder.input_feat_proj", zeros))
           for m in ("mv", "pc")}
    match = [scales[-1], obj["mv"], obj["pc"]]
    pairwise = pairwise_center(qlocs)
    query = torch.zeros_like(qpos)
    cls_out, mask_out = [], []
    r = 0
    for _ in range(arch["num_blocks"]):
        for i in range(arch["num_layers"]):
            cls, mask = mask_head(sd, query, match, seg_valid,
                                  arch["filter_out_classes"])
            cls_out.append(cls)
            mask_out.append(mask)
            attend = attend_from(forced[r])
            r += 1
            name = f"unified_encoder.layer{i}"
            mems = {"voxel": scales[i], **obj}
            ups = [cross_attention(sd, f"{name}.cross_attns_{m}", H, query,
                                   qpos, mems[m], mpos, attend)
                   for m in ("voxel", "mv", "pc")]
            query = torch.stack(ups).mean(0)
            query = spatial_self_attention(sd, f"{name}.self_attn", H, query,
                                           qpos, pairwise)
            query = ffn(sd, f"{name}.ffn", query)
    cls, mask = mask_head(sd, query, match, seg_valid,
                          arch["filter_out_classes"])
    cls_out.append(cls)
    mask_out.append(mask)
    return {"cls": cls_out, "mask": mask_out, "seg_valid": seg_valid}


# ------------------------------------------------------------- the ranking

def rank(cls_logits: np.ndarray, mask_logits: np.ndarray,
         seg_valid: np.ndarray, seg_to_full: np.ndarray, num_classes: int,
         topk: int) -> Dict:
    """{(query, class): (score, full-resolution mask)} of the top ``topk``
    (query, class) pairs by class probability, scored by the mean mask
    probability over the segments it keeps (> 0.5); pairs with no segment
    or no score are dropped.  A point of a segment past the last mask
    column takes the last column."""
    x = cls_logits - cls_logits.max(-1, keepdims=True)
    e = np.exp(x)
    probs = (e / e.sum(-1, keepdims=True))[:, :num_classes]
    mp = 1 / (1 + np.exp(-np.clip(mask_logits, -30, 30))) * seg_valid[:, None]
    keep = mp > 0.5
    flat = probs.reshape(-1)
    k = min(topk, len(flat))
    top = np.argpartition(-flat, k - 1)[:k]
    out = {}
    for idx in top:
        q, c = divmod(int(idx), num_classes)
        m = keep[:, q]
        if not m.any():
            continue
        score = float(flat[idx]) * float(mp[m, q].mean())
        if score <= 0.0:
            continue
        out[(q, c)] = (score, m[np.minimum(seg_to_full, len(m) - 1)])
    return out
