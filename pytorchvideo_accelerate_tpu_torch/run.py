"""CLI entry point of the port's training (counterpart of the JAX package's
`run.py`, the same flags):

    python -m pytorchvideo_accelerate_tpu_torch.run --synthetic \\
        --model.name slowfast_r50 --model.num_classes 700 --num_frames 32 \\
        --data.crop_size 256 --batch_size 8 --gradient_accumulation_steps 4

`--write_config out.json` resolves all flags into one JSON and exits;
`--export_inference PATH` restores the checkpoint (`--resume_from_checkpoint`)
and writes a serving artifact; `--eval_only` runs the validation loop once;
otherwise `fit()`. Add `--cpu` to train on the CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence

from pytorchvideo_accelerate_tpu_torch.config import parse_cli
from pytorchvideo_accelerate_tpu_torch.trainer.loop import Trainer


def main(argv: Optional[Sequence[str]] = None) -> dict:
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    write_to = None
    rest = []
    i = 0
    while i < len(argv):  # both --write_config PATH and --write_config=PATH
        tok = argv[i]
        key = tok[2:].split("=", 1)[0].replace("-", "_") if tok.startswith("--") else ""
        if key == "write_config":
            if "=" in tok:
                write_to = tok.split("=", 1)[1]
                i += 1
            else:
                if i + 1 >= len(argv) or argv[i + 1].startswith("--"):
                    raise SystemExit(f"{tok} requires a file path")
                write_to = argv[i + 1]
                i += 2
            if not write_to:
                raise SystemExit(f"{tok} requires a file path")
        else:
            rest.append(tok)
            i += 1

    cfg = parse_cli(rest)
    if write_to is not None:
        with open(write_to, "w") as f:
            f.write(cfg.to_json() + "\n")
        print(f"wrote resolved config to {write_to} "
              f"(reuse with --config {write_to})")
        return {"config_written": write_to}
    trainer = Trainer(cfg)
    if cfg.export_inference:
        try:
            trainer._maybe_resume()
            out = trainer.export_inference(cfg.export_inference)
        finally:
            trainer.close()
        print(f"wrote inference artifact to {out}")
        return {"exported": out}
    if cfg.eval_only:
        return trainer.evaluate()
    return trainer.fit()


if __name__ == "__main__":
    main()
