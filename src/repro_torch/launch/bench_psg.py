"""Paper Tab. 2: 32-bit SGD against 8-bit fixed point, SignSGD and PSG (the
JAX package's ``benchmarks/bench_psg.py``, with its rows and fields).

Accuracy comes from training the bench model (``bench_common.TINY``) with
each regime; energy savings come from the paper's 45nm per-op model
(``core/energy.py``).  Rows ``tab2/{sgd32,fixed8,signsgd,psg}``, each
``name,us_per_call,derived`` with microseconds per nominal step.

``fixed8`` is PSG with ``beta=0`` and no SWA.  The reference's comment calls
that "always the full product", but its select calls an element confident
when ``|g_msb| >= tau``: at ``tau = 0`` every element is confident, the
predictor's sign is taken everywhere and no tile falls back.  The port keeps
the reference's behaviour and row.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.core.config import E2TrainConfig, PSGConfig
from repro_torch.core.energy import FP32_MAC_PJ, mac_energy_pj
from repro_torch.launch.bench_common import (csv_row, eval_accuracy,
                                             final_loss, run_lm)

FIXED8 = E2TrainConfig(psg=PSGConfig(enabled=True, beta=0.0, swa=False))
# the 8-bit regime's MAC energy saving against fp32 (8x8, 16x8, 8x16)
FIXED8_SAVING = 1 - (mac_energy_pj(8, 8) + mac_energy_pj(16, 8)
                     + mac_energy_pj(8, 16)) / (3 * FP32_MAC_PJ)


def run(fast: bool = True, device=None, steps: Optional[int] = None
        ) -> List[str]:
    steps = steps or (60 if fast else 240)
    rows = []

    # 32-bit SGD baseline
    hist, tr, wall = run_lm(E2TrainConfig(), steps, device=device)
    rows.append(csv_row("tab2/sgd32", wall / steps * 1e6,
                        f"loss={final_loss(hist):.4f};"
                        f"acc={eval_accuracy(tr):.4f};energy_saving=0.000"))

    # 8-bit fixed point: quantized forward and backward, sign update
    hist, tr, wall = run_lm(FIXED8, steps, lr=0.03, optimizer="signsgd",
                            device=device)
    rows.append(csv_row("tab2/fixed8", wall / steps * 1e6,
                        f"loss={final_loss(hist):.4f};"
                        f"acc={eval_accuracy(tr):.4f};"
                        f"energy_saving={FIXED8_SAVING:.3f}"))

    # SignSGD (full-precision gradients, sign update): no energy saving
    hist, tr, wall = run_lm(E2TrainConfig(), steps, lr=0.03,
                            optimizer="signsgd", device=device)
    rows.append(csv_row("tab2/signsgd", wall / steps * 1e6,
                        f"loss={final_loss(hist):.4f};"
                        f"acc={eval_accuracy(tr):.4f};energy_saving=0.000"))

    # PSG (predictive sign, mixed precision, SWA): the saving at the 0.4
    # design point beside the one from the measured fallback-tile ratio
    e2_psg = E2TrainConfig(psg=PSGConfig(enabled=True))
    hist, tr, wall = run_lm(e2_psg, steps, lr=0.03, optimizer="psg",
                            device=device)
    rep = tr.energy_report(steps=steps)
    if rep.psg.measured is None:
        raise RuntimeError("the PSG run produced no fallback measurement")
    rows.append(csv_row("tab2/psg", wall / steps * 1e6,
                        f"loss={final_loss(hist):.4f};"
                        f"acc={eval_accuracy(tr):.4f};"
                        f"energy_saving={1 - rep.psg_factor_assumed:.3f};"
                        f"measured_fallback={rep.psg.measured:.3f};"
                        f"energy_saving_measured="
                        f"{1 - rep.psg_factor_measured:.3f}"))
    return rows
