"""Evaluate stage: segmentation vs ground truth -> F1 / SEG metrics
(reference parity: ``cellulus/evaluate.py:9-105``).

A copy of the JAX package's framework-free ``evaluate.py``.

The pairwise IoU/IoG tables are computed with a single joint-histogram
bincount over the label images — O(N) instead of the reference's
O(P x G x N) per-pair boolean scans — with identical results.

Metrics:
- F1: instance matching at IoU > 0.5,
- SEG: sum of IoU over GT objects matched at IoG > 0.5, divided by #GT.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .configs import InferenceConfig
from .io import DatasetMetaData, zarr


def compute_pairwise_IoU(
    prediction: np.ndarray, groundtruth: np.ndarray
) -> Optional[Tuple[np.ndarray, float, int]]:
    """Return ``(IoU_table (P, G), SEG_sum, num_GT)`` or None without GT."""
    prediction = np.asarray(prediction)
    groundtruth = np.asarray(groundtruth)
    pred_ids = np.unique(prediction)
    pred_ids = pred_ids[pred_ids != 0]
    gt_ids = np.unique(groundtruth)
    gt_ids = gt_ids[gt_ids != 0]
    if len(gt_ids) == 0:
        return None

    # densify ids to [0, P] / [0, G] (0 = background)
    pred_map = np.zeros(int(prediction.max()) + 1, dtype=np.int64)
    pred_map[pred_ids] = np.arange(1, len(pred_ids) + 1)
    gt_map = np.zeros(int(groundtruth.max()) + 1, dtype=np.int64)
    gt_map[gt_ids] = np.arange(1, len(gt_ids) + 1)
    p = pred_map[prediction.ravel()]
    g = gt_map[groundtruth.ravel()]

    joint = np.bincount(
        p * (len(gt_ids) + 1) + g,
        minlength=(len(pred_ids) + 1) * (len(gt_ids) + 1),
    ).reshape(len(pred_ids) + 1, len(gt_ids) + 1)
    intersection = joint[1:, 1:].astype(np.float64)
    pred_sizes = joint[1:, :].sum(axis=1, keepdims=True)
    gt_sizes = joint[:, 1:].sum(axis=0, keepdims=True)
    union = pred_sizes + gt_sizes - intersection
    IoU_table = np.where(union > 0, intersection / np.maximum(union, 1), 0.0)
    IoG_table = intersection / np.maximum(gt_sizes, 1)
    SEG_sum = float(IoU_table[IoG_table > 0.5].sum())
    return IoU_table, SEG_sum, len(gt_ids)


def compute_F1(
    IoU_table: np.ndarray, threshold: float = 0.5
) -> Tuple[float, int, int, int]:
    thresholded = IoU_table > threshold
    FP = int(np.sum(thresholded.sum(axis=1) == 0))
    FN = int(np.sum(thresholded.sum(axis=0) == 0))
    TP = IoU_table.shape[1] - FN
    return 2 * TP / max(2 * TP + FP + FN, 1), TP, FP, FN


def evaluate_arrays(
    segmentations: np.ndarray, groundtruths: np.ndarray
) -> Dict[str, float]:
    """Evaluate stacked ``(s, *spatial)`` predictions vs ground truth."""
    TP = FP = FN = 0
    SEG_sum = 0.0
    n_gt = 0
    for s in range(len(segmentations)):
        res = compute_pairwise_IoU(segmentations[s], groundtruths[s])
        if res is None:
            continue
        IoU, seg_image, n = res
        _, tp, fp, fn = compute_F1(IoU)
        TP, FP, FN = TP + tp, FP + fp, FN + fn
        SEG_sum += seg_image
        n_gt += n
    return {
        "F1": 2 * TP / max(2 * TP + FP + FN, 1),
        "SEG": SEG_sum / max(n_gt, 1),
        "TP": TP,
        "FP": FP,
        "FN": FN,
    }


def evaluate(inference_config: InferenceConfig) -> Dict[int, Dict[str, float]]:
    dataset_config = inference_config.dataset_config
    meta = DatasetMetaData.from_dataset_config(dataset_config)

    f = zarr.open(inference_config.evaluation_dataset_config.container_path, "r")
    ds_segmentation = f[
        inference_config.evaluation_dataset_config.secondary_dataset_name
    ]
    ds_groundtruth = f[inference_config.evaluation_dataset_config.dataset_name]

    results: Dict[int, Dict[str, float]] = {}
    for bandwidth in range(inference_config.num_bandwidths):
        sample_rows: List[Tuple] = []
        TP_total = FP_total = FN_total = 0
        SEG_dataset = 0.0
        n_ids_dataset = 0
        for sample in range(meta.num_samples):
            groundtruth = np.asarray(ds_groundtruth[sample, 0]).astype(np.uint16)
            prediction = np.asarray(ds_segmentation[sample, bandwidth]).astype(
                np.uint16
            )
            returned = compute_pairwise_IoU(prediction, groundtruth)
            if returned is None:
                continue
            IoU, SEG_image, n_GT = returned
            F1_image, TP, FP, FN = compute_F1(IoU)
            sample_rows.append(
                (sample, F1_image, SEG_image / n_GT, TP, FP, FN)
            )
            TP_total += TP
            FP_total += FP
            FN_total += FN
            SEG_dataset += SEG_image
            n_ids_dataset += n_GT
            print(f"{sample}: F1={F1_image:.3f}, SEG={SEG_image / n_GT:.3f}")

        F1_dataset = (
            2 * TP_total / max(2 * TP_total + FP_total + FN_total, 1)
        )
        SEG_final = SEG_dataset / max(n_ids_dataset, 1)
        print(f"F1 for dataset  is {F1_dataset:.05f}")
        print(f"SEG for dataset  is {SEG_final:.05f}")
        results[bandwidth] = {"F1": F1_dataset, "SEG": SEG_final}

        with open(f"results_bandwidth-{bandwidth}.txt", "w") as out:
            out.write("file index, F1, SEG, TP, FP, FN \n")
            out.write("+++++++++++++++++++++++++++++++++\n")
            for row in sample_rows:
                out.write(
                    f"{row[0]}, {row[1]:.05f}, {row[2]:.05f}, "
                    f"{row[3]}, {row[4]}, {row[5]}\n"
                )
            out.write("+++++++++++++++++++++++++++++++++\n")
            out.write(f"F1 for complete dataset is {F1_dataset:.05f} \n")
            out.write(f"SEG for complete dataset is {SEG_final:.05f} \n")
    return results
