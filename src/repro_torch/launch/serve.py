"""The port's serving entry point: batched prefill + greedy decode for
every LM family (dense, moe, ssm, hybrid, encdec).

  python -m repro_torch.launch.serve --arch qwen2-0.5b --full-config \\
      --batch 8 --prompt-len 2048 --gen 64
  python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b \\
      --full-config --batch 8 --prompt-len 2048 --gen 16
  python -m repro_torch.launch.serve --arch mamba2-370m --full-config
  python -m repro_torch.launch.serve --arch hymba-1.5b --full-config
  python -m repro_torch.launch.serve --arch qwen2-vl-7b --full-config \\
      --batch 8 --prompt-len 2048 --gen 16
  python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 \\
      --full-config --batch 8 --prompt-len 2048 --gen 16

Runs on the GPU (``--device cuda``, the default): prefill attention
through the hand-written flash-attention forward kernel (``--attn-impl
flash``, the default, on full-causal archs) or the chunked plain path
(``--attn-impl chunked``), decode attention through the hand-written
decode kernel, and the SSM mixer's prefill scan (mamba2, hymba's SSM
branch) through the hand-written SSD chunked-scan kernel; the SSM decode
step is plain PyTorch, as in the reference.  The moe family
(moonshot-v1-16b-a3b, mixtral-8x7b) routes and dispatches its tokens in
plain PyTorch (``models/moe.py``, as the reference's jnp code), decode at
the reference's decode capacity factor; mixtral's sliding window takes
the chunked prefill path, as in the reference, and its whole 87 GiB of
bf16 weights does not fit one 80 GB card.  qwen2-vl-7b's prompt is
``embeds`` (its vision frontend is a stub, as in the reference: random
embeddings), rotated with M-RoPE; its decode steps embed the greedy ids.
seamless-m4t-large-v2 encodes ``src_embeds`` (``--prompt-len //
enc_seq_divisor`` frames; a shorter prompt is an error) with the
non-causal encoder on the chunked path and cross-attends to it: in
prefill through the chunked path, in decode through the decode kernel
over the cross K and V, a second launch a layer.  The cache holds each
family's leaves (``LM.init_cache``): the SSM state and conv tail have no
sequence axis, the cross K and V the source's length.  ``--device cpu``
runs the plain PyTorch versions; without a GPU and without ``--device
cpu`` it stops with an error.  Without ``--full-config`` it serves the
reduced config, as the reference's ``repro.launch.serve`` does.  Weights
are the reference's seed-0 draws (``jax.random.normal``'s stream,
``models.params.init_params``), drawn on the serving device straight
into bf16 (the MoE router in float32); prompts are the reference's
``make_batch`` draws.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.launch.shapes import make_batch
from repro_torch.models.params import init_params
from repro_torch.models.registry import ARCH_IDS, get_config
from repro_torch.models.transformer import COMPUTE_DTYPE, LM, build_defs
from repro_torch.train.steps import build_prefill_step, build_serve_step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (non-reduced) config")
    ap.add_argument("--attn-impl", default="flash",
                    choices=("chunked", "flash"),
                    help="prefill attention: the flash kernel or the "
                         "chunked plain path (sets ModelConfig.attn_impl)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if min(args.batch, args.prompt_len, args.gen) < 1:
        ap.error("--batch, --prompt-len and --gen must be >= 1")
    cfg = get_config(args.arch)
    if cfg.family == "encdec" and args.prompt_len < cfg.enc_seq_divisor:
        ap.error(f"--prompt-len must be >= {cfg.enc_seq_divisor} for "
                 f"{args.arch}: its encoder reads --prompt-len // "
                 f"{cfg.enc_seq_divisor} source frames")
    return args


def serve(args) -> dict:
    """Draw the weights, prefill the prompt, then ``gen - 1`` greedy
    decode steps.  Returns the times (the draw, prefill and decode, each
    ending in a device synchronize), the generated ids (B, gen), the
    prefill's last logits and the last decode step's logits (on the CPU)
    and the peak device memory (None on the CPU)."""
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("[serve] no CUDA device: the port serves on the "
                         "GPU; pass --device cpu to run the plain PyTorch "
                         "path on the CPU")
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    dev = torch.device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = LM(cfg, init_params(build_defs(cfg), seed=0, device=dev,
                                dtype=COMPUTE_DTYPE))
    sync()
    t_init = time.perf_counter() - t0
    S_total = args.prompt_len + args.gen
    prefill = build_prefill_step(model, cache_len=S_total)
    serve_step = build_serve_step(model)
    batch = make_batch(cfg, args.batch, args.prompt_len, kind="prefill",
                       device=dev)

    sync()
    t0 = time.perf_counter()
    prefill_logits, cache = prefill(batch)
    tok = torch.argmax(prefill_logits[:, -1, :], -1).to(torch.int32)[:, None]
    sync()
    t_prefill = time.perf_counter() - t0

    toks = [tok]
    logits = prefill_logits
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        logits, cache, nxt = serve_step(tok, cache, args.prompt_len + i)
        tok = nxt[:, None]
        toks.append(tok)
    sync()
    t_decode = time.perf_counter() - t0

    steps = args.gen - 1
    out = {"arch": cfg.name, "init_s": t_init, "prefill_ms": 1e3 * t_prefill,
           "decode_ms": 1e3 * t_decode,
           "decode_ms_per_step": 1e3 * t_decode / steps if steps else None,
           "tok_per_s": steps * args.batch / t_decode if steps else None,
           "tokens": torch.cat(toks, dim=1).cpu().numpy(),
           "prefill_logits": prefill_logits.cpu(), "logits": logits.cpu(),
           "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                          if dev.type == "cuda" else None)}
    print(f"[serve] {cfg.name} on {args.device}: weights drawn in "
          f"{t_init:.2f} s; prefill({args.batch}x"
          f"{args.prompt_len}) {out['prefill_ms']:.1f} ms; decode {steps} "
          f"steps {out['decode_ms']:.1f} ms"
          + (f" ({out['decode_ms_per_step']:.3f} ms/step, "
             f"{out['tok_per_s']:.1f} tok/s)" if steps else "")
          + (f"; peak device memory {out['peak_bytes'] / 2**30:.2f} GiB"
             if out["peak_bytes"] is not None else ""))
    print("[serve] sample token ids:", out["tokens"][0, :16].tolist())
    return out


def main(argv=None) -> dict:
    return serve(parse_args(argv))


if __name__ == "__main__":
    main()
