"""Batched serving from the command line: random weights from
``--seed``, random prompts, ``Engine.generate``, tokens per second.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --batch 4 --prompt-len 16 --max-new 32            # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      --smoke --device cpu                              # small, CPU
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch olmo-1b                                    # on the card

``--arch`` is any of ``configs.ARCHS``: tinyllama-1.1b, olmo-1b,
qwen2.5-3b, command-r-plus-104b, olmoe-1b-7b, qwen3-moe-235b-a22b,
recurrentgemma-9b, rwkv6-3b, paligemma-3b, whisper-large-v3 (``--arch
whisper-large-v3 --smoke --device cpu`` runs the encoder-decoder here;
its requests take 64 stub frame embeddings, standard normal from
``--seed``). ``--max-len`` sizes the attention layers' KV caches (a local
layer keeps at most its window); a causal layer's must hold the prompt
and the new tokens, or the engine refuses the request.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config, smoke
from ..models import init_model
from ..models.common import device_of
from ..serving.engine import Engine, ServeConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = smoke(args.arch) if args.smoke else get_config(args.arch)
    params = init_model(cfg, args.seed, device=args.device)
    gen = torch.Generator(device=device_of(args.device)).manual_seed(
        args.seed)
    enc = None
    if cfg.kind == "audio":     # stub frame embeddings
        enc = torch.randn((args.batch, 64, cfg.d_model), generator=gen,
                          device=gen.device).to(cfg.cdtype)
    eng = Engine(params, cfg,
                 ServeConfig(batch=args.batch, max_len=args.max_len,
                             temperature=args.temperature),
                 device=args.device, enc_embeds=enc)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=eng.device)
    t0 = time.monotonic()
    out = eng.generate(prompt, args.max_new, generator=gen)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.monotonic() - t0
    tps = args.batch * args.max_new / dt
    print(f"generated {tuple(out.shape)} on {eng.device} in {dt:.2f}s "
          f"({tps:.1f} tok/s)")
    print(out[0].tolist())
    return out


if __name__ == "__main__":
    main()
