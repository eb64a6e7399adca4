#!/usr/bin/env python
"""Plug a user-written CUDA attention kernel into the PyTorch port.

  python examples/custom_kernel_torch/run.py                # on the card
  python examples/custom_kernel_torch/run.py --device cpu   # plain version

1. Holds ``custom_flash_mha`` (``fmha_cuda.py``, the kernel of ``fmha.cu``)
   against the port's unfused ``multihead_attention`` on [2,4,256,64]
   fp32, causal and not, to 1e-3.
2. Installs it with ``set_custom_mha`` and runs the port's Whisper-tiny
   fp32 encoder (seeded weights) through it, against the same encoder with
   the built-in dispatch, to 2e-2.
"""
import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, HERE)


def check(ok, what):
    if not ok:
        raise SystemExit(f"custom kernel example FAILED: {what}")


def random_encoder(config, device, seed=0, scale=0.05):
    """The port's Whisper encoder with seeded numpy weights N(0, scale)."""
    import numpy as np
    import torch

    from eddie_wang_hackathon2023_tpu_torch.models.whisper import \
        WhisperEncoder
    with torch.device(device):
        enc = WhisperEncoder(config)
    rng = np.random.default_rng(seed)
    enc.load_state_dict({
        name: torch.from_numpy(rng.standard_normal(tuple(t.shape),
                                                   dtype=np.float32) * scale)
        for name, t in enc.state_dict().items()})
    return enc.eval()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    args = p.parse_args(argv)
    import numpy as np
    import torch
    from fmha_cuda import custom_flash_mha

    from eddie_wang_hackathon2023_tpu_torch.functional import causal_bias
    from eddie_wang_hackathon2023_tpu_torch.models.whisper import \
        whisper_config
    from eddie_wang_hackathon2023_tpu_torch.ops.attention import \
        multihead_attention
    from eddie_wang_hackathon2023_tpu_torch.ops.flash_attention import \
        set_custom_mha
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # 1. numerics: custom kernel vs the port's unfused attention
    rs = np.random.RandomState(0)
    for causal in (False, True):
        q, k, v = (torch.from_numpy(rs.randn(2, 4, 256, 64)
                                    .astype(np.float32)).to(dev)
                   for _ in range(3))
        got = custom_flash_mha(q, k, v, causal=causal, scale=0.125)
        bias = causal_bias(256, 256, device=dev) if causal else None
        ref = multihead_attention(q, k, v, bias=bias, scale=0.125)
        err = float((got - ref).abs().max())
        print(f"causal={causal}: max |custom - reference| = {err:.2e}")
        check(err < 1e-3, f"causal={causal}: {err:.2e} >= 1e-3")

    # 2. install it framework-wide and run a real encoder through it
    config = whisper_config("tiny", dtype="float32")
    enc = random_encoder(config, dev)
    mel = torch.from_numpy(rs.randn(1, config.n_mels, 3000)
                           .astype(np.float32) * 0.1).to(dev)
    with torch.inference_mode():
        baseline = enc(mel)
        set_custom_mha(custom_flash_mha)
        try:
            custom = enc(mel)
        finally:
            set_custom_mha(None)
    err = float((custom.float() - baseline.float()).abs().max())
    print(f"whisper-tiny encoder with custom kernel: max diff {err:.2e}")
    check(err < 2e-2, f"encoder: {err:.2e} >= 2e-2")
    print("custom kernel example OK")


if __name__ == "__main__":
    main()
