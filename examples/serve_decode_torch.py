"""Batched serving with the port: prefill a batch of prompts, then decode
greedily token by token against the KV cache.

The twin of ``examples/serve_decode.py``: the same reduced config (default
gemma3-1b), the reference's seed-0 weights, the same prompts
(``launch.shapes.make_batch``), batch 4, prompt 32, 16 tokens, through
``build_prefill_step`` and ``build_serve_step``.  The same steps take a
``DeviceMesh`` (``launch.mesh.make_device_mesh``) to split the KV cache on
its sequence dim over the mesh's ``model`` ranks (the near-data decode:
each rank reduces over its own slice, only the partials cross); on one
process there is no mesh, as in the reference example's host mesh.

Run:  PYTHONPATH=src python examples/serve_decode_torch.py [arch] \\
          [--device cpu]
"""

import argparse
import time

import torch

from repro_torch.launch.shapes import make_batch
from repro_torch.models.params import init_params
from repro_torch.models.registry import get_config
from repro_torch.models.transformer import LM, build_defs
from repro_torch.train.steps import build_prefill_step, build_serve_step

ap = argparse.ArgumentParser()
ap.add_argument("arch", nargs="?", default="gemma3-1b")
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
args = ap.parse_args()
if args.device == "cuda" and not torch.cuda.is_available():
    raise SystemExit("no CUDA device: pass --device cpu to serve on the CPU")
B, PROMPT, GEN = 4, 32, 16

cfg = get_config(args.arch).reduced()
model = LM(cfg, init_params(build_defs(cfg), seed=0, device=args.device))
print(f"{cfg.name} (family={cfg.family}): batch={B}, prompt={PROMPT}, "
      f"gen={GEN}")

with torch.no_grad():
    prefill = build_prefill_step(model, cache_len=PROMPT + GEN)
    serve = build_serve_step(model)
    batch = make_batch(cfg, B, PROMPT, kind="prefill", device=args.device)
    logits, cache = prefill(batch)
    tok = torch.argmax(logits[:, -1, :], -1).to(torch.int32)[:, None]
    out = [tok]
    t0 = time.time()
    for i in range(GEN - 1):
        logits, cache, nxt = serve(tok, cache, PROMPT + i)
        tok = nxt[:, None]
        out.append(tok)
    if args.device == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0

ids = torch.cat(out, dim=1).cpu()
print(f"decoded {GEN-1} steps x {B} seqs in {dt*1e3:.0f} ms "
      f"({(GEN-1)*B/dt:.1f} tok/s)")
for b in range(min(B, 2)):
    print(f"  seq{b}: {ids[b].tolist()}")
