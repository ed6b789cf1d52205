"""The port's command line (python -m kurosiwo_torch) on the CPU: the
repository's configs/ copied and cut to a tiny size (batch 4, 32x32
synthetic patches, 8 samples a split, f32), trained, checkpointed, reloaded
and tested; then "test": true evaluates the saved best without training.

Exactness class (ROADMAP C5): bit-exact within torch (the eval-only run
scores the trained run's best checkpoint to the same mIoU).
"""

import json
import pathlib
import re
import shutil

import numpy as np
import pytest
import torch

from kurosiwo_torch import __main__ as cli
from kurosiwo_torch.config import load_json5

torch.set_num_threads(2)

CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "configs"


def _configs(tmp_path, **top) -> pathlib.Path:
    root = tmp_path / "configs"
    shutil.copytree(CONFIGS, root)
    for rel, kw in (("config.json", {"mixed_precision": False, "synthetic_size": 8,
                                     "synthetic_patch_size": 32, **top}),
                    ("train/train_config.json", {"batch_size": 4, "num_workers": 2})):
        path = root / rel
        path.write_text(json.dumps({**load_json5(path), **kw}))
    return root


def _run(root, capsys, *extra) -> tuple[float, str]:
    miou = cli.main(["--method", "unet", "--backbone", "resnet18", "--seed", "7",
                     "--config_root", str(root), "--device", "cpu", *extra])
    return miou, capsys.readouterr().out


def test_cli_trains_checkpoints_and_tests(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    root = _configs(tmp_path)
    with pytest.warns(UserWarning, match="RANDOM init"):  # unet.json asks for imagenet weights
        miou, out = _run(root, capsys)
    assert "Samples in Train Set:  8" in out
    assert "Restored best_segmentation for the final test eval" in out
    printed = re.search(r"^Test Mean IOU:\s+(\S+)$", out, re.M)
    assert printed and float(printed.group(1)) == miou and 0.0 <= miou <= 100.0
    run = tmp_path / "checkpoints/UNet/resnet18/vv-vh_patches_3/RandomEvents"
    assert (run / "best_segmentation.txt").exists() and (run / "latest.ptr.json").exists()

    # "test": true scores the saved best, without training
    eval_root = _configs(tmp_path / "eval", test=True)
    with pytest.warns(UserWarning, match="RANDOM init"):
        eval_miou, out = _run(eval_root, capsys)
    assert "Eval-only: restored best_segmentation" in out and "new best" not in out
    assert eval_miou == miou


# the MAE method config cut to a CPU size in the test's copy of configs/ (the
# shipped one is ViT-L at accum 4)
MAE_TINY = {"image_size": 32, "dim": 32, "depth": 1, "heads": 2, "mlp_dim": 32,
            "decoder_dim": 32, "decoder_depth": 1, "decoder_heads": 2}
# the diffusion method config cut the same way (the shipped one is dim 64,
# dim_mults (1, 2, 4, 8), 1000 timesteps)
DIFFUSION_TINY = {"dim": 8, "dim_mults": [1, 2], "timesteps": 10}


@pytest.mark.parametrize("argv,top,item", [
    (["--method", "convlstm"], {}, None),
    (["--method", "mae"], {"task": "mae"}, None),
    (["--method", "diffusion"], {"task": "diffusion-unsup"}, None),
], ids=["convlstm", "mae", "diffusion"])
def test_unported_tasks_name_their_roadmap_item(tmp_path, monkeypatch, capsys, argv, top, item):
    """Every task main.py dispatches is ported (a task that is not would
    raise naming its ROADMAP item, before any directory is made). The
    recurrent task (``--method convlstm``, A7), MAE pretraining (``"task":
    "mae"``, A8) and diffusion pretraining (``--method diffusion``, A10) run
    at a tiny size: convlstm trains, writes ``checkpoint_epoch=0`` and
    prints its test mIoU; mae trains its epoch (2 steps of batch 4 at accum
    4) and writes ``mae_0`` and ``vit_0``; diffusion trains its epoch (24
    typed records of 8 patches: 6 steps of batch 4, printed at 0) and writes
    ``diffusion_0`` in ``checkpoints/diffusion-unsup/``."""
    monkeypatch.chdir(tmp_path)
    root = _configs(tmp_path, **top)
    argv = [*argv, "--config_root", str(root), "--device", "cpu"]
    if item is not None:
        with pytest.raises(NotImplementedError, match=rf"ROADMAP\.md, {item}\)"):
            cli.main(argv)
        assert not (tmp_path / "checkpoints").exists()
        return
    if "mae" in argv:
        path = root / "method" / "mae" / "mae.json"
        path.write_text(json.dumps({**load_json5(path), **MAE_TINY}))
        assert cli.main([*argv, "--batch_size", "4"]) is None
        out = capsys.readouterr().out
        assert "Initializing Self-Supervised learning training" in out
        losses = [float(x) for x in re.findall(r"loss=(\S+) lr=", out)]
        # 8 synthetic samples: 2 steps, printed at iteration 0 (print_frequency 10)
        assert len(losses) == 1 and np.isfinite(losses).all() and "MAE epoch 0: " in out
        run = tmp_path / "checkpoints/mae/vit/vit_6/RandomEvents"
        assert {f.name for f in run.iterdir()} >= {"mae_0.ptr.json", "vit_0.ptr.json"}
        return
    if "diffusion" in argv:
        path = root / "method" / "diffusion" / "diffusion.json"
        path.write_text(json.dumps({**load_json5(path), **DIFFUSION_TINY}))
        assert cli.main(argv) is None
        out = capsys.readouterr().out
        losses = [float(x) for x in re.findall(r"^diffusion epoch 0 iter \d+: loss=(\S+)$", out,
                                               re.M)]
        assert len(losses) == 1 and np.isfinite(losses).all() and "'batch_size': 4" in out
        run = tmp_path / "checkpoints/diffusion-unsup"
        assert {f.name for f in run.iterdir()} == {"diffusion_0.a", "diffusion_0.ptr.json"}
        return
    miou = cli.main(argv)
    out = capsys.readouterr().out
    assert re.search(r"^Test Mean IOU:\s+(\S+)$", out, re.M) and 0.0 <= miou <= 100.0
    run = tmp_path / "checkpoints/convlstm"
    assert (run / "checkpoint_epoch=0.ptr.json").exists() and (run / "latest.ptr.json").exists()


# the attention change-detection methods' model-config files, cut to a CPU
# size in the test's copy of configs/ (ChangeFormer's encoder and BiT's stay
# at their published widths)
CD_WIDTHS = {"bit-cd": {}, "changeformer": {"embed_dim": 32},
             "transunet-cd": {"out_channels": 16, "head_num": 2, "mlp_dim": 32, "block_num": 2}}


@pytest.mark.parametrize("method", sorted(CD_WIDTHS))
def test_cli_runs_the_attention_cd_methods(tmp_path, monkeypatch, capsys, method):
    """BiT-CD (its shipped base_resnet18), ChangeFormer and TransUNet-CD
    through the CLI with the cd task, as main.py runs them, at batch 2 and
    32x32: train, checkpoint (checkpoint_epoch=0), test."""
    monkeypatch.chdir(tmp_path)
    root = _configs(tmp_path, task="cd")
    path = root / "method" / method / (method.replace("-", "_") + ".json")
    path.write_text(json.dumps({**load_json5(path), **CD_WIDTHS[method]}))
    miou = cli.main(["--method", method, "--inputs", "pre_event_1", "post_event", "--batch_size",
                     "2", "--seed", "7", "--config_root", str(root), "--device", "cpu"])
    out = capsys.readouterr().out
    printed = re.search(r"^Test Mean IOU:\s+(\S+)$", out, re.M)
    assert printed and float(printed.group(1)) == miou and 0.0 <= miou <= 100.0
    assert "'task': 'cd'" in out and "'batch_size': 2" in out
    runs = list((tmp_path / "checkpoints" / method).iterdir())
    assert len(runs) == 1 and (runs[0] / "checkpoint_epoch=0.ptr.json").exists()


def test_cli_defaults_to_the_card():
    args = cli.build_parser().parse_args([])
    assert args.device == "cuda" and args.seed == 999 and args.config_root == "configs"
