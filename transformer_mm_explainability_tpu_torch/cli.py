"""Command-line entry point of the PyTorch port.

    python -m transformer_mm_explainability_tpu_torch.cli explain-vit IMG \
        [--checkpoint CKPT] [--class-index N] [--output PNG] [--seed S] \
        [--device cuda|cpu]
    python -m transformer_mm_explainability_tpu_torch.cli explain-clip IMG \
        TEXT [TEXT ...] [--checkpoint CLIP.pt] [--start-layer N] \
        [--start-layer-text N] [--output-prefix P] [--seed S] \
        [--device cuda|cpu]
    python -m transformer_mm_explainability_tpu_torch.cli perturbation \
        [--model visual_bert|lxmert] [--method ours_no_lrp] \
        [--num-samples N] [--is-positive-pert BOOL] [--is-text-pert BOOL] \
        [--questions JSON --features TSV --ans2label JSON --label2ans JSON \
        --bert-vocab TXT] [--checkpoint CKPT] [--seed S] [--device cuda|cpu]
    python -m transformer_mm_explainability_tpu_torch.cli lxmert-finetune \
        [--task vqa|gqa|nlvr2] [--train-questions JSON --features TSV \
        --ans2label JSON --label2ans JSON --bert-vocab TXT] \
        [--valid-questions JSON] [--llayers 9 --xlayers 5 --rlayers 5] \
        [--batch-size 32] [--lr 5e-5] [--epochs 4] [--checkpoint CKPT] \
        [--seed S] [--device cuda|cpu]
    python -m transformer_mm_explainability_tpu_torch.cli detr-eval \
        --coco-path DIR [--annotations JSON] [--max-images N] \
        [--shortest 800] [--method ours_no_lrp] [--checkpoint DETR.pth] \
        [--seed S] [--device cuda|cpu]
    python -m transformer_mm_explainability_tpu_torch.cli verify-parity \
        --family vit|clip|visual_bert|lxmert|detr|all [--weights CKPT] \
        [--generate] [--reference DIR] [--out JSON] [--device cuda|cpu]
    python -m transformer_mm_explainability_tpu_torch.cli bench \
        [--device cuda|cpu]
    python -m transformer_mm_explainability_tpu_torch.cli protocol-rehearsal \
        [--protocol all|visualbert|lxmert|detr] [--out JSON] \
        [--vb-samples N] [--vb-batch N] [--lx-samples N] [--detr-images N] \
        [--method M] [--device cuda|cpu]
    python -m transformer_mm_explainability_tpu_torch.cli predict \
        --annotations IMDB --features DIR --bert-vocab TXT \
        [--dataset vqa2] [--label2ans TXT] [--report-folder DIR] \
        [--file-format json|csv] [--batch-size 32] [--max-samples N] \
        [--max-seq-length 128] [--max-features 100] [--checkpoint CKPT] \
        [--seed S] [--device cuda|cpu]

``explain-vit`` computes the ViT-B/16 relevancy map through
``models/vit.relevancy_fused_block2`` (the block kernels on CUDA, their
plain versions on the CPU) and writes the overlay figure. Without
``--checkpoint`` the weights are random, drawn from ``--seed``.

``explain-clip`` runs ``explain/clip.interpret`` (CLIP ViT-B/32 unless the
checkpoint says otherwise) on the image and the texts, writes one overlay
PNG per text (``PREFIX_i.png``) and prints the softmax over the texts.

``perturbation`` is the JAX package's subcommand (the same flags, plus
``--device``): the VisualBERT (default) or LXMERT positive / negative
perturbation benchmark through ``harness/pert_runner``. Without the data
flags it runs the pipeline on synthetic samples and a tiny random model.
Every method of the model's table runs, the LRP ones included; an unknown
method exits with 2.

``lxmert-finetune`` is the JAX package's subcommand (the same flags, plus
``--device``): the LXMERT VQA / GQA / NLVR2 finetune loop of
``train/lxmert_tasks`` (BertAdam, the per-epoch train and valid accuracy),
printing one JSON line (``loss``, ``train_acc``, ``valid_acc``,
``best_valid``). Without the data flags it trains a tiny random LXMERT on
synthetic batches and exits 1 unless its loss falls.

``detr-eval`` is the JAX package's subcommand (the same flags, plus
``--device``): DETR explanation-segmentation on a COCO split through
``harness/detr_eval.evaluate`` (DETR-R50; random weights from ``--seed``
without ``--checkpoint``), printing the 12 COCO segm stats as one JSON
line. Without ``--coco-path`` it prints a hint and exits 0. Every DETR
method runs, the LRP ones included.

``verify-parity`` is the JAX package's subcommand (the same flags, plus
``--device`` and ``--out``): the port against the maps the original
reference computed (``tools/verify_parity``; the fixtures in
``data/assets/parity``). It exits 1 when a map misses the tool's rule and
2 when ``--generate`` finds no reference checkout.

``bench`` prints the ViT-B/16 maps/s line of ``bench.py`` (kernels #1-#4
through ``relevancy_fused_block2`` at B = 32 on ``cuda``).

``protocol-rehearsal`` is the JAX package's subcommand (the same flags,
plus the sample counts and ``--device``): the three quantitative
protocols at full width on synthetic weights and data
(``tools/protocol_rehearsal``), one JSON artifact.

``predict`` is the JAX package's subcommand (the same flags, plus
``--device``): VisualBERT (``VISUAL_BERT_VQA2``; random weights from
``--seed`` without ``--checkpoint``) over a registered MMF dataset through
``harness/predict.predict_visual_bert``, printing the paths of the
report files it writes. Without ``--bert-vocab`` it exits 2.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np
import torch


def str2bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "y")


# union of the per-model method families; each runner validates its own
# surface (pert_runner.VISUALBERT_METHODS / LXMERT_METHODS + aliases)
METHODS = ["ours_with_lrp", "ours_no_lrp", "transformer_att",
           "transformer_attribution", "partial_lrp", "raw_attn",
           "attn_gradcam", "rollout", "ours_no_lrp_no_norm",
           "ours_no_lrp_no_normalization",
           "ours_with_lrp_no_normalization", "ablation_no_self_in_10",
           "ablation_no_aggregation"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tmmx-torch")
    sub = p.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("explain-vit", help="ViT-B/16 relevancy map")
    sp.add_argument("image", help="image path (png/jpg)")
    sp.add_argument("--checkpoint", default=None,
                    help="timm ViT state dict (torch.save) to convert+load")
    sp.add_argument("--class-index", type=int, default=None)
    sp.add_argument("--output", default="vit_relevancy.png")
    sp.add_argument("--seed", type=int, default=1234)
    sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    sp = sub.add_parser("explain-clip", help="CLIP bi-modal relevancy")
    sp.add_argument("image", help="image path (png/jpg)")
    sp.add_argument("texts", nargs="+")
    sp.add_argument("--checkpoint", default=None,
                    help="OpenAI CLIP .pt (TorchScript or state dict)")
    sp.add_argument("--start-layer", type=int, default=-1)
    sp.add_argument("--start-layer-text", type=int, default=-1)
    sp.add_argument("--output-prefix", default="clip_relevancy")
    sp.add_argument("--seed", type=int, default=1234)
    sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    sp = sub.add_parser("perturbation",
                        help="pos/neg perturbation benchmark")
    sp.add_argument("--model", choices=["visual_bert", "lxmert"],
                    default="visual_bert")
    sp.add_argument("--num-samples", type=int, default=10000)
    sp.add_argument("--batch-size", type=int, default=8,
                    help="samples per explain+perturb call (protocol "
                         "results are batch-size invariant)")
    sp.add_argument("--is-positive-pert", type=str2bool, default=False)
    sp.add_argument("--is-text-pert", type=str2bool, default=False)
    sp.add_argument("--questions", default=None, help="VQA questions json")
    sp.add_argument("--features", default=None, help="object-features TSV")
    sp.add_argument("--ans2label", default=None)
    sp.add_argument("--label2ans", default=None)
    sp.add_argument("--bert-vocab", default=None,
                    help="vocab.txt (bert-base-uncased layout)")
    sp.add_argument("--method", default="ours_no_lrp", choices=METHODS,
                    help="explanation method (reference --method)")
    sp.add_argument("--checkpoint", default=None,
                    help="MMF VisualBERT checkpoint (.ckpt/.pth or a "
                         "tarball) or LXMERT torch state dict")
    sp.add_argument("--seed", type=int, default=1234)
    sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    sp = sub.add_parser("lxmert-finetune",
                        help="LXMERT task finetune loop "
                             "(lxmert/src/tasks/vqa.py + "
                             "run/vqa_finetune.bash surface)")
    sp.add_argument("--task", choices=["vqa", "gqa", "nlvr2"],
                    default="vqa")
    sp.add_argument("--train-questions", default=None)
    sp.add_argument("--valid-questions", default=None)
    sp.add_argument("--features", default=None, help="object TSV")
    sp.add_argument("--ans2label", default=None)
    sp.add_argument("--label2ans", default=None)
    sp.add_argument("--bert-vocab", default=None)
    sp.add_argument("--llayers", type=int, default=9)
    sp.add_argument("--xlayers", type=int, default=5)
    sp.add_argument("--rlayers", type=int, default=5)
    sp.add_argument("--batch-size", type=int, default=32)
    sp.add_argument("--lr", type=float, default=5e-5)
    sp.add_argument("--epochs", type=int, default=4)
    sp.add_argument("--checkpoint", default=None)
    sp.add_argument("--seed", type=int, default=9595)
    sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    sp = sub.add_parser("detr-eval",
                        help="DETR explanation-segmentation eval")
    sp.add_argument("--coco-path", default=None,
                    help="dir containing annotations json + images")
    sp.add_argument("--annotations", default=None,
                    help="instances json (defaults to "
                         "<coco-path>/annotations/instances_val2017.json)")
    sp.add_argument("--masks", action="store_true")
    sp.add_argument("--max-images", type=int, default=None)
    sp.add_argument("--shortest", type=int, default=800)
    sp.add_argument("--method", default="ours_no_lrp", choices=METHODS,
                    help="explanation method (reference --method)")
    sp.add_argument("--checkpoint", default=None,
                    help="DETR release checkpoint (detr-r50-e632da11.pth)")
    sp.add_argument("--seed", type=int, default=1234)
    sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    sp = sub.add_parser("predict",
                        help="prediction run -> EvalAI-style report "
                             "files (mmf_cli/predict.py flow)")
    sp.add_argument("--dataset", default="vqa2",
                    help="registered builder name")
    sp.add_argument("--annotations", required=True,
                    help="imdb .npy/.json annotation db")
    sp.add_argument("--features", required=True,
                    help="feature dir or .lmdb store")
    sp.add_argument("--bert-vocab", default=None,
                    help="vocab.txt (bert-base-uncased layout)")
    sp.add_argument("--label2ans", default=None,
                    help="answer-vocab txt (one answer per line) to "
                         "map class indices to strings")
    sp.add_argument("--report-folder", default="./reports")
    sp.add_argument("--file-format", choices=["json", "csv"],
                    default="json")
    sp.add_argument("--batch-size", type=int, default=32)
    sp.add_argument("--max-samples", type=int, default=None)
    sp.add_argument("--max-seq-length", type=int, default=128)
    sp.add_argument("--max-features", type=int, default=100)
    sp.add_argument("--method", default="ours_no_lrp", choices=METHODS,
                    help="accepted for the JAX command's surface; unused")
    sp.add_argument("--checkpoint", default=None,
                    help="MMF VisualBERT checkpoint (.ckpt/.pth or a "
                         "tarball)")
    sp.add_argument("--seed", type=int, default=1234)
    sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    sp.add_argument("opts", nargs="*", default=[],
                    help="config dotlist overrides key=value (accepted "
                         "for the JAX command's surface; unused)")

    from transformer_mm_explainability_tpu_torch.tools import verify_parity
    verify_parity.build_parser(sub.add_parser(
        "verify-parity", help="the port against the reference's own maps "
                              "(fixtures, or --weights)"))

    sp = sub.add_parser("bench", help="ViT-B/16 relevancy maps/s")
    sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    from transformer_mm_explainability_tpu_torch.tools import (
        protocol_rehearsal)
    protocol_rehearsal.build_parser(sub.add_parser(
        "protocol-rehearsal",
        help="protocol-scale rehearsal of the quantitative harnesses"))
    return p


def cmd_explain_vit(args) -> int:
    from PIL import Image

    from transformer_mm_explainability_tpu_torch._device import resolve_device
    from transformer_mm_explainability_tpu_torch.models import vit
    from transformer_mm_explainability_tpu_torch.ops import image as img_ops
    from transformer_mm_explainability_tpu_torch.utils import convert
    from transformer_mm_explainability_tpu_torch.utils import (
        visualization as viz)

    device = resolve_device(args.device)
    cfg = vit.VIT_B_16
    if args.checkpoint:
        sd = torch.load(args.checkpoint, map_location="cpu")
        model, cfg = convert.vit_from_state_dict(sd, device)
    else:
        print("note: no --checkpoint; using random weights (smoke mode)")
        model = vit.init_params(args.seed, cfg, device)

    raw = np.array(Image.open(args.image).convert("RGB"))
    # timm vit_base_patch16_224 transform: bicubic resize + center crop,
    # 0.5/0.5 normalisation
    img = torch.as_tensor(raw, dtype=torch.float32, device=device) / 255.0
    img = img_ops.normalize(
        img_ops.center_crop(
            img_ops.resize_shortest_edge(img, cfg.image_size,
                                         method="bicubic"),
            cfg.image_size),
        (0.5, 0.5, 0.5), (0.5, 0.5, 0.5))
    images = img[None].contiguous()
    with torch.no_grad():
        logits, _ = vit.forward(model, images)
    target = (int(logits[0].argmax()) if args.class_index is None
              else args.class_index)
    rel = vit.relevancy_fused_block2(
        model, images, torch.tensor([target], device=device))[0]
    fig = viz.relevancy_figure(img.cpu().numpy(), rel.cpu().numpy(),
                               (cfg.grid, cfg.grid))
    Image.fromarray(fig).save(args.output)
    print(json.dumps({"class_index": target, "output": args.output}))
    return 0


def explain_clip(args) -> dict:
    """``explain-clip``'s work: ``{"probs", "outputs"}`` (what the command
    prints) and the text side, ``R_text`` ``[B, S, S]`` and ``tokens``, for
    callers that render it (``examples/clip_explainability``)."""
    from PIL import Image

    from transformer_mm_explainability_tpu_torch._device import resolve_device
    from transformer_mm_explainability_tpu_torch.data import bpe
    from transformer_mm_explainability_tpu_torch.explain import clip as expl
    from transformer_mm_explainability_tpu_torch.models import clip
    from transformer_mm_explainability_tpu_torch.ops import image as img_ops
    from transformer_mm_explainability_tpu_torch.utils import (
        visualization as viz)

    device = resolve_device(args.device)
    if args.checkpoint:
        from transformer_mm_explainability_tpu_torch.utils.clip_loader import (
            load_clip)

        params, cfg = load_clip(args.checkpoint, device)
    else:
        print("note: no --checkpoint; using random weights (smoke mode)")
        cfg = clip.CLIP_VIT_B_32
        params = clip.init_params(args.seed, cfg, device)

    raw = np.array(Image.open(args.image).convert("RGB"))
    img = img_ops.clip_preprocess(torch.as_tensor(raw, device=device),
                                  cfg.image_resolution)
    tokens = torch.as_tensor(bpe.tokenize(args.texts, cfg.context_length),
                             device=device)
    R_txt, R_img, logits = expl.interpret(
        params, img, tokens, cfg, start_layer=args.start_layer,
        start_layer_text=args.start_layer_text)
    grid = cfg.image_resolution // cfg.vision_patch_size
    probs = torch.softmax(logits, -1)[0].cpu().numpy()
    img_np, R_img = img.cpu().numpy(), R_img.cpu().numpy()
    outputs = []
    for i in range(len(args.texts)):
        out = f"{args.output_prefix}_{i}.png"
        Image.fromarray(viz.relevancy_figure(img_np, R_img[i],
                                             (grid, grid))).save(out)
        outputs.append(out)
    return {"probs": probs.tolist(), "outputs": outputs, "R_text": R_txt,
            "tokens": tokens}


def cmd_explain_clip(args) -> int:
    res = explain_clip(args)
    print(json.dumps({"probs": res["probs"], "outputs": res["outputs"]}))
    return 0


def cmd_perturbation(args) -> int:
    from transformer_mm_explainability_tpu_torch._device import resolve_device
    from transformer_mm_explainability_tpu_torch.harness import pert_runner

    resolve_device(args.device)
    try:
        return pert_runner.run_from_args(args)
    except ValueError as e:
        if "perturbation method" in str(e):
            print(f"perturbation: {e}")
            return 2
        raise


def cmd_detr_eval(args) -> int:
    import os

    if not args.coco_path:
        print("detr-eval: pass --coco-path DIR (images) and "
              "--annotations instances.json; see harness/detr_eval.py "
              "for the programmatic API.")
        return 0

    from transformer_mm_explainability_tpu_torch._device import resolve_device
    from transformer_mm_explainability_tpu_torch.data.coco import (
        CocoDetection)
    from transformer_mm_explainability_tpu_torch.explain import detr as expl
    from transformer_mm_explainability_tpu_torch.harness import (detr_eval,
                                                                 detr_segm)
    from transformer_mm_explainability_tpu_torch.models import detr

    if args.method not in expl.DETR_METHODS:
        print(f"detr-eval: {args.method!r} is not a DETR method; valid: "
              f"{sorted(expl.DETR_METHODS)}")
        return 2
    device = resolve_device(args.device)
    ann = args.annotations or os.path.join(
        args.coco_path, "annotations", "instances_val2017.json")
    dataset = CocoDetection(ann, image_root=args.coco_path)
    if args.checkpoint:
        from transformer_mm_explainability_tpu_torch.utils.clip_loader import (
            load_detr)

        params, cfg = load_detr(args.checkpoint, device=device)
    else:
        print("note: no --checkpoint; random weights (protocol smoke)")
        cfg = detr.DETR_R50
        params = detr.init_params(args.seed, cfg, device)
    result = detr_eval.evaluate(
        params, dataset, cfg, detr_segm.SegmConfig(method=args.method),
        max_images=args.max_images, shortest=args.shortest)
    print(json.dumps(result))
    return 0


def cmd_lxmert_finetune(args) -> int:
    from transformer_mm_explainability_tpu_torch.train import lxmert_tasks

    return lxmert_tasks.run_from_args(args)


def cmd_verify_parity(args) -> int:
    from transformer_mm_explainability_tpu_torch.tools import verify_parity

    return verify_parity.run(args)


def cmd_bench(args) -> int:
    from transformer_mm_explainability_tpu_torch import bench

    return bench.main(["--device", args.device])


def cmd_protocol_rehearsal(args) -> int:
    from transformer_mm_explainability_tpu_torch.tools import (
        protocol_rehearsal)

    return protocol_rehearsal.run(args)


def cmd_predict(args) -> int:
    from transformer_mm_explainability_tpu_torch._device import resolve_device
    from transformer_mm_explainability_tpu_torch.core.env import setup_imports
    from transformer_mm_explainability_tpu_torch.core.registry import registry
    from transformer_mm_explainability_tpu_torch.harness import predict
    from transformer_mm_explainability_tpu_torch.models import (
        visual_bert as vb)

    setup_imports()  # register the builders and processors

    if not args.bert_vocab:
        print("predict: pass --bert-vocab vocab.txt "
              "(bert-base-uncased layout)")
        return 2
    device = resolve_device(args.device)

    dcfg = {
        "annotations": args.annotations,
        "features": args.features,
        "max_features": args.max_features,
        "processors": {
            "text_processor": {
                "type": "bert_tokenizer",
                "params": {
                    "tokenizer_config": {"vocab_path": args.bert_vocab},
                    "max_seq_length": args.max_seq_length}},
        },
    }
    builder = registry.get("builder", args.dataset)()
    dataset = builder.load(dcfg, "test")

    cfg = vb.VISUAL_BERT_VQA2
    if args.checkpoint:
        from transformer_mm_explainability_tpu_torch.utils.mmf_loader import (
            load_visual_bert)

        params, cfg = load_visual_bert(args.checkpoint, cfg, device=device)
    else:
        params = vb.init_params(args.seed, cfg, device)

    label2ans = None
    if args.label2ans:
        with open(args.label2ans, encoding="utf-8") as f:
            label2ans = [ln.rstrip("\n") for ln in f if ln.strip()]

    written = predict.predict_visual_bert(
        params, cfg, dataset, args.report_folder,
        dataset_name=args.dataset, batch_size=args.batch_size,
        label2ans=label2ans, max_samples=args.max_samples,
        file_format=args.file_format)
    for path in written:
        print(path)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return {"explain-vit": cmd_explain_vit,
            "explain-clip": cmd_explain_clip,
            "perturbation": cmd_perturbation,
            "lxmert-finetune": cmd_lxmert_finetune,
            "detr-eval": cmd_detr_eval,
            "verify-parity": cmd_verify_parity,
            "bench": cmd_bench,
            "protocol-rehearsal": cmd_protocol_rehearsal,
            "predict": cmd_predict}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
