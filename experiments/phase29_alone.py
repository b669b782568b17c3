"""Phase 29 of ``chip_smoke.py`` alone: build the libraries it needs,
save an initialised ResNet-50 (gate (vi) loads phase 6's zip, and phase 6
is not run here), run the phase and print its kernels' records.

    python3 experiments/phase29_alone.py
"""
import json, sys, time
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke as cs
from deeplearning4j_tpu_torch.environment import card_info
from deeplearning4j_tpu_torch.kernels import (bn_relu, dropout, lstm,
                                              recurrence)
from concurrent.futures import ThreadPoolExecutor

t0 = time.perf_counter()
with ThreadPoolExecutor(4) as ex:
    for f in [ex.submit(bn_relu._phase1_lib), ex.submit(dropout._lib),
              ex.submit(lstm._lib), ex.submit(recurrence._lib)]:
        f.result()
print("built", time.perf_counter() - t0, flush=True)
dev = torch.device("cuda")
card = card_info()
name = torch.cuda.get_device_name(0)
from deeplearning4j_tpu_torch.zoo import ResNet50
net = ResNet50(height=224, width=224, channels=3, num_classes=1000).build(
    device=dev)
cs.p29_resnet_snapshot(net, torch.tensor(np.random.default_rng(1)
                                         .standard_normal((8, 3, 224, 224),
                                                          dtype=np.float32),
                                         device=dev))
del net
torch.cuda.empty_cache()
t0 = time.perf_counter()
recs, summary = cs.phase_recurrent(dev, card, name)
print("phase 29", time.perf_counter() - t0, "s", flush=True)
print(json.dumps({"kernels": recs}), flush=True)
print(json.dumps(summary, default=str), flush=True)
print(card)
