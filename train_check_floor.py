#!/usr/bin/env python3
"""How far apart correct fp32 runs of ``chip_smoke.py``'s reduced train
check fall, and whether its check holds on any host.

    python3 train_check_floor.py

The reduced TRAIN_ARCH takes TRAIN_CHECK_STEPS AdamW steps from seed 0 on
the CPU in one process for each VARIANTS entry: the CPU's thread count, its
instruction set (``ATEN_CPU_CAPABILITY``, ``MKL_ENABLE_INSTRUCTIONS``) or
MKL's reproducible mode (``MKL_CBWR``). Each variant is correct; they
differ only in the order in which they sum. With CUDA the card takes the
same steps too. One line for each pair against the default CPU run (and
against the card's): the largest parameter difference free-running (in
units of the learning rate, with the first step's gradient at that entry
against its leaf's largest), the entries past 0.01 / 0.05 / 0.1 x lr, and
the first step's gradients, each entry against its leaf's largest. With
CUDA each variant's process then runs ``chip_smoke.train_check`` itself,
whose CPU side is that variant, and its line is printed. It exits non-zero
if one of those checks failed. Without CUDA only the CPU variants run.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))
sys.path.insert(0, str(HERE))
VARIANTS = {
    "default": {},
    "1 thread": {"OMP_NUM_THREADS": "1"},
    "2 threads": {"OMP_NUM_THREADS": "2"},
    "avx2": {"ATEN_CPU_CAPABILITY": "avx2",
             "MKL_ENABLE_INSTRUCTIONS": "AVX2"},
    "avx2, 1 thread": {"ATEN_CPU_CAPABILITY": "avx2",
                       "MKL_ENABLE_INSTRUCTIONS": "AVX2",
                       "OMP_NUM_THREADS": "1"},
    "MKL_CBWR": {"MKL_CBWR": "COMPATIBLE"},
}


def run(device: str) -> dict:
    """The reduced train check's free-running steps on ``device``: the
    first step's gradients and the final parameters, on the host."""
    import chip_smoke as cs
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import data_iterator
    from repro_torch.models import Model, trainable
    from repro_torch.models.params import _leaves, _map
    from repro_torch.training import AdamWConfig
    from repro_torch.training.train_loop import batch_to
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = reduced(get_config(cs.TRAIN_ARCH))
    model = Model.init(cfg, seed=0, device="cpu", requires_grad=True,
                       remat=True)
    if device != "cpu":
        model = Model(cfg, trainable(_map(
            lambda _, t: t.detach().to(device, copy=True),
            model.param_tree())), remat=True)
    leaves = list(_leaves(model.param_tree()))
    batch = next(data_iterator(cfg, cs.TRAIN_CHECK_SEQ, 2, seed=0))
    grads = torch.autograd.grad(model.loss(batch_to(batch, model.device)),
                                [t for _, t in leaves])
    opt = AdamWConfig(lr=cs.TRAIN_CHECK_LR, schedule=cfg.lr_schedule,
                      warmup_steps=2, total_steps=cs.TRAIN_CHECK_STEPS)
    params, _, _ = cs._train_run(model, opt, data_iterator(
        cfg, cs.TRAIN_CHECK_SEQ, 2, seed=0), cs.TRAIN_CHECK_STEPS)
    return {"grads": {p: g.detach().cpu() for (p, _), g in
                      zip(leaves, grads)},
            "params": {p: t.detach().cpu().clone()
                       for p, t in _leaves(params)},
            "threads": torch.get_num_threads(),
            "isa": torch.backends.cpu.get_cpu_capability()}


def compare(a: dict, b: dict, lr: float) -> str:
    """``b`` against ``a``: module docstring."""
    diff = {p: (b["params"][p].double() - t.double()).abs()
            for p, t in a["params"].items()}
    flat = torch.cat([d.flatten() for d in diff.values()])
    path = max(diff, key=lambda p: diff[p].max().item())
    at = int(diff[path].flatten().argmax())
    g = a["grads"][path]
    grad = max(((b["grads"][p] - t).abs().max()
                / t.abs().max().clamp(min=1e-30)).item()
               for p, t in a["grads"].items())
    return (f"parameters {flat.max().item() / lr:.3f} x lr at "
            f"{'.'.join(map(str, path))}[{at}] (its first gradient "
            f"{g.flatten()[at].item():.2e}, its leaf's largest "
            f"{g.abs().max().item():.2e}); entries past 0.01 / 0.05 / 0.1 "
            f"x lr {[int((flat > q * lr).sum()) for q in (0.01, 0.05, 0.1)]}"
            f" of {flat.numel()}; first gradients {grad:.2e} of their "
            "leaf's largest")


def variant(out: str):
    """One variant's process: its CPU run into ``out``, then with CUDA
    ``chip_smoke.train_check`` (its CPU side this variant)."""
    torch.save(run("cpu"), out)
    if torch.cuda.is_available():
        import chip_smoke as cs
        cs.train_check(cs.card_line())


def main() -> int:
    import chip_smoke as cs
    cuda = torch.cuda.is_available()
    if cuda:
        print(cs.card_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, CPU "
          f"{torch.backends.cpu.get_cpu_capability()}, "
          f"{os.cpu_count()} cores", flush=True)
    runs, failed = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for name, env in VARIANTS.items():
            out = os.path.join(tmp, "run.pt")
            t0 = time.time()
            proc = subprocess.run(
                [sys.executable, __file__, "--variant", out],
                env=dict(os.environ, **env), capture_output=True, text=True)
            if not os.path.exists(out):
                print(f"{name}: failed\n{proc.stderr[-3000:]}", flush=True)
                failed.append(name)
                continue
            runs[name] = torch.load(out)
            os.remove(out)
            line = [ln for ln in proc.stdout.splitlines()
                    if ln.startswith("[train]")]
            verdict = "FAILED" if proc.returncode else "passed"
            print(f"{name} ({runs[name]['threads']} threads, "
                  f"{runs[name]['isa']}), {time.time() - t0:.1f} s: "
                  f"train_check {verdict}"
                  + (f": {line[0]}" if line else ""), flush=True)
            if proc.returncode:
                failed.append(name)
    lr = cs.TRAIN_CHECK_LR
    base = runs.get("default")
    for name, r in runs.items():
        if base is not None and name != "default":
            print(f"CPU {name} vs CPU default: {compare(base, r, lr)}",
                  flush=True)
    if cuda:
        card = run("cuda")
        for name, r in runs.items():
            print(f"card vs CPU {name}: {compare(r, card, lr)}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--variant":
        variant(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
