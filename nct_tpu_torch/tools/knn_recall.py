"""Graph recall of the k-NN builder against the reference-exact graph
(port of ``tools/knn_recall.py``).

    python -m nct_tpu_torch.tools.knn_recall [--pair 0] [--size 256]
        [--level 3] [--device cuda|cpu] [--example DIR]

On a demo pair's clusters and Lab colours at ``--level``: the coarsest VGG
tap of the content (float32), L2-normalised and clustered by k-means; the
level's cluster memberships and unit Lab; the numpy-exact graph
(``solve/knn_exact.exact_knn_graph``: every dilated membership, all
members).  Then the id and weight recall (``graph_recall``) of six
configurations of ``solve/knn.knn_graph``: the default (primary cluster,
2,048 candidates), all candidates, and 2, 3 and 4 memberships.  Draws in
the JAX tool's order: the k-means initial centres, then one candidate
score draw shared by all six rows.  Without converted weights, the seeded
VGG-19.  Deviations from the JAX tool: ``--device`` (default cuda, raising
without a card) and ``--example`` are added (``tools/demo.py``).
"""

from __future__ import annotations

import argparse
import time

import torch

from nct_tpu_torch.config import Config
from nct_tpu_torch.models import vgg19
from nct_tpu_torch.ops import features
from nct_tpu_torch.ops.color import bgr_u8_to_lab_u8
from nct_tpu_torch.ops.resize import resize_bilinear
from nct_tpu_torch.solve import cluster, knn
from nct_tpu_torch.solve.knn_exact import exact_knn_graph, graph_recall
from nct_tpu_torch.tools import demo
from nct_tpu_torch.tools.bench import resolve_device


def rows_of(n_pixels: int) -> list[tuple[str, int, int]]:
    """(name, memberships, candidates) of the six configurations."""
    m = min(2048, n_pixels)
    return [("default", 1, m), ("full candidates", 1, n_pixels),
            ("memberships=2", 2, m), ("memberships=3", 3, m),
            ("memberships=3 + full", 3, n_pixels),
            ("memberships=4 + full", 4, n_pixels)]


def level_clusters(model, d, cnt: torch.Tensor, level: int,
                   config: Config) -> dict:
    """The k-means clusters of ``cnt``'s coarsest VGG tap (float32,
    L2-normalised; initial centres from ``d.kmeans_init``) and at
    ``level``'s grid: {"label_map", "membership", "lab" (unit Lab),
    "member_pix"}."""
    h, w = cnt.shape[:2]
    dims = vgg19.feature_dims(h, w)
    taps = config.vgg_layers()
    ah, aw = dims[taps[level]]
    feats = model(cnt, (taps[0],), torch.float32)[taps[0]]
    lh, lw = dims[taps[0]]
    f0n, _ = features.l2_normalize(feats.float())
    init_idx = d.kmeans_init(lh * lw, config.cluster_num)
    label_map, _ = cluster.kmeans(f0n.reshape(lh * lw, -1), init_idx,
                                  num_clusters=config.cluster_num,
                                  iters=config.kmeans_iters)
    label_map = label_map.reshape(lh, lw)
    membership = cluster.cluster_membership(label_map, config.cluster_num)
    lab = bgr_u8_to_lab_u8(resize_bilinear(cnt, ah, aw)).float() / 255.0
    return {"label_map": label_map, "membership": membership, "lab": lab,
            "member_pix": cluster.membership_for_pixels(membership, ah, aw,
                                                        2 ** level)}


def recall(model, draws, device, example: str, pair: int = 0,
           size: int = 256, level: int = 3, out=demo.say) -> list[dict]:
    """Print the table; returns its rows: {"config", "memberships",
    "candidates", "id_recall", "weight_recall"}.  ``draws()`` gives the
    one draws object of the run."""
    config = Config()
    cnt, _ = demo.read_pair(example, pair, size)
    cnt = torch.from_numpy(cnt).to(device)
    d = draws()
    cl = level_clusters(model, d, cnt, level, config)
    label_map, membership = cl["label_map"], cl["membership"]
    lab_d, member_pix = cl["lab"], cl["member_pix"]
    ah, aw = lab_d.shape[:2]
    stride = 2 ** level

    t0 = time.perf_counter()
    ex_ids, ex_w = exact_knn_graph(lab_d.cpu().numpy(),
                                   member_pix.cpu().numpy(), config.k_num)
    t_exact = time.perf_counter() - t0
    n_memb = member_pix.cpu().numpy().sum(0)
    out(f"pair in{pair} L{level} grid {aw}x{ah} (N={ah * aw}), "
        f"memberships/pixel mean {n_memb.mean():.2f} max "
        f"{int(n_memb.max())}; exact build {t_exact:.0f}s")
    out("| config | candidates M | id recall | weight recall | note |")
    out("|---|---|---|---|---|")

    scores = d.candidate_scores(level, member_pix.shape[0], ah * aw)
    rows = []
    for name, memberships, m_cand in rows_of(ah * aw):
        candidates = knn.sample_cluster_candidates(member_pix, scores,
                                                   m_cand)
        if memberships > 1:
            labels = cluster.multi_labels_for_pixels(
                label_map, membership, ah, aw, stride, memberships)
        else:
            labels = cluster.labels_for_pixels(label_map, ah, aw, stride)
        ids, ws, _ = knn.knn_graph(lab_d, labels, candidates,
                                   k_num=config.k_num)
        rid, rw = graph_recall(ids.cpu().numpy(), ws.cpu().numpy(), ex_ids,
                               ex_w)
        rows.append({"config": name, "memberships": memberships,
                     "candidates": m_cand, "id_recall": float(rid),
                     "weight_recall": float(rw)})
        out(f"| {name} | {m_cand} | {rid:.4f} | {rw:.6f} | |")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pair", type=int, default=0)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--level", type=int, default=3)
    demo.add_options(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    recall(demo.load_model(None, device), demo.seeded_draws(), device,
           demo.example_dir(args.example), args.pair, args.size, args.level)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
