"""CLI launcher: `python -m koboldcpp_tpu_torch model.gguf`.

Port of koboldcpp_tpu/cli.py for the flags the port serves: the model
(positional or --model), --port, --host, --contextsize, --password,
--prompt / --promptlimit (one-shot mode), --multiuser [N] (continuous
batching over N KV slots; bare = 5), --paged / --pagesize (the paged KV
pool for it), --quantkv 0|1|2 (bf16 / Q8 / Q4 KV cache, routed as the JAX
launcher routes it), --flashattention (accepted, a no-op) and --device. Any
other flag, such as the JAX launcher's --mesh, exits with argparse's error
naming it. Runs on the GPU unless --device cpu is given.
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
    p.add_argument("--multiuser", type=int, nargs="?", const=5, default=1,
                   help="max concurrent requests; > 1 serves them by "
                        "continuous batching over that many KV slots")
    p.add_argument("--paged", action="store_true",
                   help="paged KV pool for the continuous-batching engine")
    p.add_argument("--pagesize", type=int, default=64)
    p.add_argument("--contextsize", type=int, default=2048)
    p.add_argument("--prompt", default="", help="one-shot prompt mode")
    p.add_argument("--promptlimit", type=int, default=100)
    p.add_argument("--quantkv", type=int, default=0, choices=(0, 1, 2),
                   help="KV cache quantization: 0=bf16 1=q8 2=q4")
    p.add_argument("--flashattention", action="store_true",
                   help="accepted for compatibility; prefill from position "
                        "0 always runs flash attention on the GPU")
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
    from .engine.batch_engine import BatchedEngine, batch_capable
    from .models.loader import load_model

    print(f"Loading model: {model_path}")
    t0 = time.time()
    model = load_model(model_path, device=args.device)
    print(f"Load took {time.time() - t0:.1f}s ({model.cfg.arch}, "
          f"{model.cfg.n_layers} layers, vocab {model.cfg.vocab_size}) "
          f"on {model.device}")
    batched = args.multiuser > 1 and batch_capable(model.cfg)
    if args.multiuser > 1 and not batched:
        print(f"Note: --multiuser continuous batching is unavailable for "
              f"this configuration (arch {model.cfg.arch}); serving with "
              f"the single-sequence engine + FIFO queue")
    if args.paged and args.quantkv == 2:
        print("Paged KV pool: Q4 (plane-split nibbles, half the Q8 memory)")
    if batched:
        # --quantkv 1 takes the paged Q8 pool (the JAX launcher's routing,
        # cli.py:432-446)
        paged = args.paged or args.quantkv == 1
        engine = BatchedEngine(model, max_context=args.contextsize,
                               n_slots=args.multiuser, paged=paged,
                               page_size=args.pagesize, device=model.device,
                               quantkv=args.quantkv)
        print(f"Continuous batching enabled: {args.multiuser} KV slots"
              + (" (paged)" if paged else ""))
    else:
        engine = Engine(model, max_context=args.contextsize,
                        device=model.device, quantkv=args.quantkv)
        if args.quantkv == 1:
            print("Q8-quantized KV cache enabled")
        elif args.quantkv == 2:
            print("Q4_0-quantized KV cache enabled (plain attention path)")

    if args.prompt:
        r = engine.generate(args.prompt, GenParams(max_length=args.promptlimit))
        print(r.text)
        if isinstance(engine, BatchedEngine):
            engine.shutdown()
        return 0

    from .server.app import ServerSettings, run_server

    settings = ServerSettings(password=args.password,
                              model_name=os.path.basename(model_path),
                              multiuser=args.multiuser)
    print(f"Starting server on {args.host}:{args.port}")
    run_server(engine, host=args.host, port=args.port, settings=settings)
    return 0


if __name__ == "__main__":
    sys.exit(main())
