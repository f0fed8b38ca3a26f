"""Retrieval R@k from the score matrices (port of
``vlm_compression_tpu/evaluation/retrieval_metrics.py``; host only).

Given the image × text score matrices and the ground-truth maps
(``txt2img``: each caption's image; ``img2txt``: each image's captions),
R@1/5/10 in both directions, their means, and ``agg_metrics`` = ``r_mean``,
the mean of the two directions' means."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def itm_eval(score_i2t: np.ndarray, score_t2i: np.ndarray,
             txt2img: List[int], img2txt: Dict[int, List[int]]
             ) -> Dict[str, float]:
    # image → text: the best rank among the image's captions
    ranks = np.zeros(score_i2t.shape[0])
    for i, row in enumerate(score_i2t):
        order = np.argsort(row)[::-1]
        best = 1e20
        for t in img2txt[i]:
            best = min(best, np.where(order == t)[0][0])
        ranks[i] = best
    tr1 = 100.0 * np.mean(ranks < 1)
    tr5 = 100.0 * np.mean(ranks < 5)
    tr10 = 100.0 * np.mean(ranks < 10)

    # text → image
    ranks = np.zeros(score_t2i.shape[0])
    for t, row in enumerate(score_t2i):
        order = np.argsort(row)[::-1]
        ranks[t] = np.where(order == txt2img[t])[0][0]
    ir1 = 100.0 * np.mean(ranks < 1)
    ir5 = 100.0 * np.mean(ranks < 5)
    ir10 = 100.0 * np.mean(ranks < 10)

    tr_mean = (tr1 + tr5 + tr10) / 3
    ir_mean = (ir1 + ir5 + ir10) / 3
    return {
        "txt_r1": tr1, "txt_r5": tr5, "txt_r10": tr10, "txt_r_mean": tr_mean,
        "img_r1": ir1, "img_r5": ir5, "img_r10": ir10, "img_r_mean": ir_mean,
        "r_mean": (tr_mean + ir_mean) / 2,
        "agg_metrics": (tr_mean + ir_mean) / 2,
    }
