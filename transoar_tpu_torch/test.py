"""Evaluation CLI of the port (twin of ``scripts/test.py``, plus
``--device``):

    python -m transoar_tpu_torch.test --run <name> [--val] [--last] \
        [--full_labeled] [--save_preds] [--save_attn_map] [--data_dir D] \
        [--device cuda]

Loads the frozen ``runs/<run>/config.json``, restores the best (or, with
``--last``, the last) checkpoint, windows each test (or ``--val``) case's
intensities as training does, decodes one box per organ
(``training/inference.py``) or, for RetinaNet, its anchors with the
config's ``retina.nms_iou`` and ``retina.score_threshold`` on the card
(``models/retina.retina_inference``; no attention maps, as
``scripts/test.py``), runs the per-class evaluator and writes
``runs/<run>/results_<split>.json`` with the full mAP family.
``--full_labeled`` skips cases missing an organ; ``--save_preds`` writes
.ply point clouds and box wireframes, ``--save_attn_map`` the last decoder
layer's attention maps as PNGs (both need numpy and PIL, scipy for the
maps; the Deformable-DETR neck has no dense map and exports none). Runs on
``cuda`` unless asked for the CPU. ``Tester.case_ms`` holds each case's
forward and decode ms (CUDA events on the card, the host clock on the
CPU).
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import numpy as np
import torch

from transoar_tpu_torch.data.dataset import get_loader
from transoar_tpu_torch.data.transforms import eval_transform
from transoar_tpu_torch.eval.evaluator import build_evaluator
from transoar_tpu_torch.models.retina import retina_inference
from transoar_tpu_torch.models.transoarnet import build_model
from transoar_tpu_torch.training import checkpoints as ckpt_lib
from transoar_tpu_torch.training.inference import inference
from transoar_tpu_torch.training.trainer import derive_targets
from transoar_tpu_torch.utils.io import set_root_logger, write_json

logger = logging.getLogger(__name__)


class Tester:
    def __init__(self, args):
        self._args = args
        self._path_to_run = Path.cwd() / "runs" / args.run
        self._config = ckpt_lib.load_run_config(self._path_to_run)
        self._split = "val" if args.val else "test"
        self._device = torch.device(args.device)

        self._model = build_model(self._config, device=self._device)
        ckpt = ckpt_lib.pick_checkpoint(self._path_to_run,
                                        prefer_best=not args.last)
        self._model.load_state_dict(ckpt_lib.load_checkpoint(ckpt,
                                                             self._device))
        self._model.eval()
        logger.info("restored checkpoint %s on %s", ckpt, self._device)
        self._loader = get_loader(self._config, self._split,
                                  data_dir=args.data_dir, batch_size=1)
        self._evaluator = build_evaluator(self._config, per_class=True)
        self._num_organs = self._config["neck"]["num_organs"]
        self._is_retina = "retina" in self._config
        self.case_ms = []  # {"forward": ms, "decode": ms} per case

    @torch.inference_mode()
    def _forward(self, image):
        """Host batch [1, S0, S1, S2, 1] -> the model's outputs on the
        device, with the intensity window of training and validation (the
        reference windows every split, transforms.py:170-177)."""
        x = torch.as_tensor(image, dtype=torch.float32).to(self._device)
        stats = self._config.get("foreground_voxel_statistics")
        if stats is not None:
            x = eval_transform(x, stats)
        if self._is_retina:
            return self._model(x)
        return self._model(x, return_weights=self._args.save_attn_map)

    def _decode(self, out):
        """(boxes, classes, scores) lists and the outputs on the host (none
        for RetinaNet, decoded where it ran)."""
        if self._is_retina:
            rcfg = self._config["retina"]
            return retina_inference(
                out, self._model.anchors, self._num_organs,
                iou_threshold=rcfg.get("nms_iou", 0.5),
                score_threshold=rcfg.get("score_threshold", 0.05)), {}
        out = {k: v.float().cpu().numpy() for k, v in out.items()}
        return inference(out, self._num_organs), out

    def _mark(self):
        if self._device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _elapsed_ms(self, a, b):
        if self._device.type != "cuda":
            return 1e3 * (b - a)
        b.synchronize()
        return a.elapsed_time(b)

    def run(self):
        num_classes = self._num_organs
        attn_dir = self._path_to_run / f"attn_maps_{self._split}"
        pred_dir = self._path_to_run / f"predictions_{self._split}"
        warned_no_attn = False

        for batch in self._loader:
            seg = torch.as_tensor(batch["seg"]).long().to(self._device)
            targets = derive_targets(seg, num_classes,
                                     self._config.get("bbox_padding", 1))
            present = targets["present"][0].cpu().numpy()

            # Skip partially labeled cases (reference test.py:96-98),
            # unless --full_labeled is cleared.
            if self._args.full_labeled and present.sum() < num_classes:
                continue

            marks = [self._mark()]
            out = self._forward(batch["image"])
            marks.append(self._mark())
            (boxes, classes, scores), out = self._decode(out)
            marks.append(self._mark())
            self.case_ms.append({
                "forward": self._elapsed_ms(*marks[:2]),
                "decode": self._elapsed_ms(*marks[1:])})
            tgt_boxes = targets["boxes"][0].cpu().numpy()
            gt_classes = np.nonzero(present)[0] + 1
            self._evaluator.add(boxes, classes, scores,
                                gt_boxes=[tgt_boxes[present]],
                                gt_classes=[gt_classes])

            case_id = int(batch["index"][0])
            if self._args.save_preds:
                from transoar_tpu_torch.utils.visualization import \
                    save_pred_visualization

                save_pred_visualization(
                    boxes[0], classes[0], scores[0], tgt_boxes[present],
                    gt_classes, np.asarray(batch["seg"])[0], pred_dir,
                    case_id)
            if self._args.save_attn_map and "attn_weights" in out:
                from transoar_tpu_torch.utils.visualization import \
                    save_attn_visualization

                save_attn_visualization(out, self._config, attn_dir, case_id,
                                        seg=np.asarray(batch["seg"])[0])
            elif self._args.save_attn_map and not warned_no_attn:
                # a deformable neck samples sparse points and RetinaNet has
                # no attention: no dense map to export (as scripts/test.py)
                warned_no_attn = True
                logger.warning("--save_attn_map: %s has no attention map; "
                               "none exported",
                               "RetinaNet" if self._is_retina else
                               f"the {self._config['neck'].get('name')} neck")

        scores_dict = self._evaluator.eval()
        write_json(scores_dict,
                   self._path_to_run / f"results_{self._split}.json")
        logger.info("mAP_coco=%.4f mAP_nndet=%.4f",
                    scores_dict["mAP_coco"], scores_dict["mAP_nndet"])
        return scores_dict


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--run", type=str, required=True,
                        help="Experiment name under ./runs.")
    parser.add_argument("--val", action="store_true",
                        help="Evaluate the val split instead of test.")
    parser.add_argument("--last", action="store_true",
                        help="Use the last instead of the best checkpoint.")
    parser.add_argument("--full_labeled", action="store_true",
                        help="Skip cases missing any class label.")
    parser.add_argument("--save_preds", action="store_true",
                        help="Export .ply prediction visualizations.")
    parser.add_argument("--save_attn_map", action="store_true",
                        help="Export decoder attention maps.")
    parser.add_argument("--data_dir", type=str, default=None,
                        help="Dataset root (default ./dataset).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device of the forward (default cuda).")
    return parser


def main(argv=None):
    """Evaluate ``--run``; returns the scores written to
    ``results_<split>.json``."""
    args = build_parser().parse_args(argv)

    set_root_logger(Path.cwd() / "logs" / "test.log")
    return Tester(args).run()


if __name__ == "__main__":
    main()
