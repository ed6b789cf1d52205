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


@pytest.mark.parametrize("argv,top,item", [
    (["--method", "siam-diff"], {"task": "cd"}, "A6"),
    (["--method", "convlstm"], {}, "A7"),
    (["--method", "mae"], {"task": "mae"}, "A8"),
    (["--method", "diffusion"], {"task": "diffusion-unsup"}, "A10"),
], ids=["cd", "convlstm", "mae", "diffusion"])
def test_unported_tasks_name_their_roadmap_item(tmp_path, monkeypatch, argv, top, item):
    monkeypatch.chdir(tmp_path)
    root = _configs(tmp_path, **top)
    with pytest.raises(NotImplementedError, match=rf"ROADMAP\.md, {item}\)"):
        cli.main([*argv, "--config_root", str(root), "--device", "cpu"])
    assert not (tmp_path / "checkpoints").exists()


def test_cli_defaults_to_the_card():
    args = cli.build_parser().parse_args([])
    assert args.device == "cuda" and args.seed == 999 and args.config_root == "configs"
