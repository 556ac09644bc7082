"""Batched serving on the PyTorch port: prefill a batch of prompts, decode
greedily.

    PYTHONPATH=src python examples/torch_serve_batch.py [--arch mixtral-8x7b]
    PYTHONPATH=src python examples/torch_serve_batch.py --device cpu

Runs the smoke-size config of the chosen arch through ``launch.serve``
with the arguments of the JAX version (``examples/serve_batch.py``),
MoE and hybrid recurrent archs included: each uses its own cache kind,
KV ring buffers for sliding-window attention, O(1) recurrent state for
RG-LRU/xLSTM.  On the card the prefill runs the hand-written
``flash_attention`` kernel and a MoE arch's experts the ``grouped_gemm``
kernel.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch.serve import main as serve_main  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return serve_main([
        "--arch", args.arch, "--smoke",
        "--batch", str(args.batch),
        "--prompt-len", str(args.prompt_len),
        "--gen", str(args.gen),
        "--device", args.device,
    ])


if __name__ == "__main__":
    main()
