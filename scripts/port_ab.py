"""Time the port's main-path steps of the source tree at a given root, to
compare two commits on one card in one call.

    python scripts/port_ab.py ROOT

imports ``distill_any_depth_tpu_torch`` from ROOT (build its kernels there
first, as the package does at first use) and prints one JSON line: the
bs16 392^2 ViT-L -> ViT-B bf16 train step with the bf16 and with the
``int8_pallas`` teacher (median of 5 windows of 3 steps on a device-resident
batch, CUDA events), the ViT-B 392^2 bs8 bf16 forward (median of 5 windows
of 10; path 1), the ViT-L 518^2 bs8 bf16 forward with ``int8_pallas`` GEMMs
(median of 5 windows of 3; path 5), the windowed teacher's 1036^2 bs8 bf16
forward (median of 5 windows of 5; path 3, kernel 7) and the windowed student's 1036^2 bs16
bf16 step under the ViT-L teacher (median of 3 windows of 2 steps; path 4,
kernels 7 and 8). Unpack the parent with ``git archive`` into a git-ignored
directory and run parent, change, change, parent in one call.
"""
import json
import statistics
import sys

root = sys.argv[1]
# in place of this script's directory, whose profile.py would shadow the
# standard library's (torch's optimizers import cProfile)
sys.path[0] = root

import torch  # noqa: E402

from distill_any_depth_tpu_torch.cli.profile_infer import cuda_ms  # noqa: E402
from distill_any_depth_tpu_torch.configs import TrainConfig, model_config  # noqa: E402
from distill_any_depth_tpu_torch.models.factory import create_model  # noqa: E402
from distill_any_depth_tpu_torch.ops import _build  # noqa: E402
from distill_any_depth_tpu_torch.train.loop import Trainer  # noqa: E402

_build.build_all()
out = {"root": root, "device": torch.cuda.get_device_name(0)}
x = torch.rand(16, 3, 392, 392, generator=torch.Generator().manual_seed(0)).cuda()
for quant in ("none", "int8_pallas"):
    cfg = TrainConfig(student=model_config("depthanything-base"), teachers=("depthanything-large",),
                      batch_size=16, image_size=392, teacher_quant=quant,
                      output_dir="build/port_ab", log_interval=10 ** 6)
    trainer = Trainer(cfg, "cuda")
    trainer._build_steps(views_shared=True)
    windows = [cuda_ms(lambda: trainer.train_step(trainer.state, 0, x, x), iters=3, warmup=1)
               for _ in range(5)]
    out[f"step_ms_{quant}"] = statistics.median(windows)
    out[f"step_windows_{quant}"] = windows
    del trainer
    torch.cuda.empty_cache()
model = create_model("depthanything-base", dtype=torch.bfloat16, device="cuda", seed=0)
xb = x[:8].to(torch.bfloat16)
with torch.no_grad():
    windows = [cuda_ms(lambda: model(xb), iters=10) for _ in range(5)]
out["forward_ms"] = statistics.median(windows)
out["forward_windows"] = windows
del model

# path 5: the ViT-L 518^2 bs8 forward with the int8_pallas GEMMs
model = create_model("depthanything-large", dtype=torch.bfloat16, device="cuda", seed=0,
                     quant="int8_pallas")
x5 = torch.rand(8, 3, 518, 518, generator=torch.Generator().manual_seed(2)).cuda()
x5 = x5.to(torch.bfloat16)
with torch.no_grad():
    windows = [cuda_ms(lambda: model(x5), iters=3) for _ in range(5)]
out["pseudo_forward_ms"] = statistics.median(windows)
out["pseudo_forward_windows"] = windows
del model, x5
torch.cuda.empty_cache()

# paths 3 and 4 at 1036^2: the windowed teacher's forward, the windowed
# student's step
WINDOW, RES4 = "depthanything-base-window", 1036
x4 = torch.rand(16, 3, RES4, RES4, generator=torch.Generator().manual_seed(1)).cuda()
model = create_model(WINDOW, dtype=torch.bfloat16, device="cuda", seed=0)
xw = x4[:8].to(torch.bfloat16)
with torch.no_grad():
    windows = [cuda_ms(lambda: model(xw), iters=5) for _ in range(5)]
out["window_forward_ms"] = statistics.median(windows)
out["window_forward_windows"] = windows
del model
torch.cuda.empty_cache()
cfg = TrainConfig(student=model_config(WINDOW), teachers=("depthanything-large",),
                  batch_size=16, image_size=RES4, output_dir="build/port_ab", log_interval=10 ** 6)
trainer = Trainer(cfg, "cuda")
trainer._build_steps(views_shared=True)
windows = [cuda_ms(lambda: trainer.train_step(trainer.state, 0, x4, x4), iters=2, warmup=1)
           for _ in range(3)]
out["window_step_ms"] = statistics.median(windows)
out["window_step_windows"] = windows
print(json.dumps(out), flush=True)
