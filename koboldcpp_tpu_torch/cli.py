"""CLI launcher: `python -m koboldcpp_tpu_torch model.gguf`.

Port of koboldcpp_tpu/cli.py for the flags this slice serves: the model
(positional or --model), --port, --host, --contextsize, --password,
--prompt / --promptlimit (one-shot mode) and --device. Any other flag,
such as the JAX launcher's --quantkv or --multiuser, exits with
argparse's error naming it. Runs on the GPU unless --device cpu is
given.
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="koboldcpp-tpu-torch",
        description="KoboldCpp-compatible LLM server on PyTorch/CUDA")
    p.add_argument("model_param", nargs="?", default="",
                   help="GGUF model file (positional)")
    p.add_argument("port_param", nargs="?", default="",
                   help="port (positional compat)")
    p.add_argument("--model", default="", help="GGUF model file")
    p.add_argument("--port", type=int, default=5001)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--password", default="", help="API key (Bearer auth)")
    p.add_argument("--contextsize", type=int, default=2048)
    p.add_argument("--prompt", default="", help="one-shot prompt mode")
    p.add_argument("--promptlimit", type=int, default=100)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch versions of the kernels)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    model_path = args.model or args.model_param
    if not model_path:
        print("error: no model specified (pass a GGUF path or --model)")
        return 2
    if args.port_param:
        args.port = int(args.port_param)

    from .engine import Engine, GenParams
    from .models.loader import load_model

    print(f"Loading model: {model_path}")
    t0 = time.time()
    model = load_model(model_path, device=args.device)
    print(f"Load took {time.time() - t0:.1f}s ({model.cfg.arch}, "
          f"{model.cfg.n_layers} layers, vocab {model.cfg.vocab_size}) "
          f"on {model.device}")
    engine = Engine(model, max_context=args.contextsize, device=model.device)

    if args.prompt:
        r = engine.generate(args.prompt, GenParams(max_length=args.promptlimit))
        print(r.text)
        return 0

    from .server.app import ServerSettings, run_server

    settings = ServerSettings(password=args.password,
                              model_name=os.path.basename(model_path))
    print(f"Starting server on {args.host}:{args.port}")
    run_server(engine, host=args.host, port=args.port, settings=settings)
    return 0


if __name__ == "__main__":
    sys.exit(main())
