"""The outputs the golden fixtures ``tests/golden/fig{2..7}.json`` hold,
from the port's runners (twin of the ``_fig*_outputs`` functions of
``tests/test_golden_figures.py``).

    outputs("fig3", fixture["regime"], device="cuda")

``regime`` is a fixture's own ``regime`` record; the result is keyed as
its ``outputs`` are, with numpy arrays and lists for values.
"""
from __future__ import annotations

from repro_torch.figures import (fig2_convergence, fig3_eps_sweep,
                                 fig4_c_sweep, fig5_unbalanced, fig6_mixed,
                                 fig7_online)

FIGURES = ("fig2", "fig3", "fig4", "fig5", "fig6", "fig7", "fig7_churn")


def outputs(name: str, regime: dict, device=None) -> dict:
    """The outputs of figure ``name``'s runner at ``regime``."""
    r = dict(regime)
    if name == "fig2":
        h_t, h_d, csv_r, _ = fig2_convergence.curves_for(
            r.pop("V"), r.pop("deg"), r.pop("n_tgt"), r.pop("seeds"),
            r.pop("iters"), device=device, **r)
        return {"dtsvm_curve": h_t, "dsvm_curve": h_d, "csvm": csv_r}
    if name == "fig3":
        risks, csvm_m, _ = fig3_eps_sweep.sweep_grid(
            r.pop("eps_grid"), r.pop("seeds"), r.pop("iters"),
            device=device, **r)
        return {"grid": [[e1, e2, *m] for (e1, e2), m in risks.items()],
                "csvm": csvm_m}
    if name == "fig4":
        risks, _ = fig4_c_sweep.sweep_grid(
            r.pop("c_grid"), r.pop("e2_grid"), r.pop("seeds"),
            r.pop("iters"), device=device, **r)
        return {"grid": [[c, e2, *m] for (c, e2), m in risks.items()]}
    if name == "fig5":
        out, _ = fig5_unbalanced.scenario_risks(
            r.pop("pos_fracs"), r.pop("seeds"), r.pop("iters"),
            device=device, **r)
        return {"scenarios": [[pf, *v] for pf, v in out.items()]}
    if name == "fig6":
        left, right, _ = fig6_mixed.mixed_network_risks(
            r.pop("seeds"), r.pop("iters"), device=device, **r)
        return {"left_dsvm": left, "right_mixed": right}
    if name == "fig7":
        marks, _ = fig7_online.stage_marks(r.pop("stage_iters"),
                                           device=device, **r)
        return marks
    if name == "fig7_churn":
        marks, _ = fig7_online.churn_marks(r.pop("stage_iters"),
                                           device=device, **r)
        return marks
    raise ValueError(f"unknown figure {name!r}; expected one of {FIGURES}")
