"""The cell added with MiMo-V2-Flash, ``mimo_v2_flash.train``, cut to a
size the CPU runs in seconds (the same files, the widths cut), through the
harness's ``Run``: untraced and traced, correct, reporting its metrics; a
selection without the correction bias refused; the MiMo work counts at the
published widths; the new readers' spans found in the program."""

import json

import pytest
import torch

from conftest import SEED
from core import spec as specs


def tiny(cell: str):
    s = specs.load_spec()
    w = specs.workload(s, cell)
    cfg = specs.load_config(s, w["config"])
    tr = specs.load_traffic(w["traffic"])
    cfg.update(hidden_size=64, swa_num_attention_heads=8, num_attention_heads=8,
               swa_num_key_value_heads=2, num_key_value_heads=1, head_dim=24,
               v_head_dim=16, sliding_window=8, intermediate_size=96,
               moe_intermediate_size=32, num_experts_per_tok=4, num_hidden_layers=4,
               n_routed_experts=4)
    cfg["published"] = dict(cfg["published"], n_routed_experts=16)
    cfg["deployment"] = dict(cfg["deployment"], first_expert=4)
    tr.update(trials=4, frames={"min": 30, "max": 60})
    return s, w, cfg, tr


def run(cell: str, trace: bool = False):
    from core.run import Run

    torch.set_num_threads(4)
    s, w, cfg, tr = tiny(cell)
    r = Run(s, w, SEED, torch.device("cpu"), trace, config=cfg, traffic=tr,
            log=lambda m: None)
    return r.execute(0.5)


@pytest.mark.parametrize("trace", [False, True])
def test_mimo_cell_runs_correct(trace):
    result = run("mimo_v2_flash.train", trace)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"loss_gap_first", "grad_gap", "change_gap", "pick_gap"}
    names = set(result["metrics"])
    if trace:
        assert {"mfu.train", "pad_share.train", "forward_ms.moe", "step_ms.forward"} <= names
        # no device on the CPU: the rooflines find no device time and read None
        assert "swa_sink_roofline" not in names and "moe_experts_roofline" not in names
    else:
        assert names == {"setup_s", "train_frames_per_s"}


def test_mimo_work_at_the_published_widths():
    from work import mimo_v2_flash as work

    cfg = specs.load_config(specs.load_spec(), "mimo_v2_flash")
    assert all(work.window_pairs(T, 128) == sum(min(t + 1, 128) for t in range(T))
               for T in (1, 100, 128, 129, 1500))
    per_frame = sum(work.forward_flops(cfg, 1000).values()) / 1000
    assert 1.8e9 < per_frame < 1.95e9
    ref = specs.load_module("reference", "mimo_v2_flash")
    n = sum(torch.Size(shape).numel() for _, shape, *_ in ref.param_spec(cfg))
    assert 2.05e9 < n < 2.1e9


def test_the_new_readers_wrap_the_programs_functions():
    for name, count in (("swa_sink_roofline", 2), ("moe_experts_roofline", 2)):
        assert len(specs.load_module("metrics", name).SPANS) == count
    cfg = json.loads((specs.ROOT / "benchmark" / "configs" / "mimo_v2_flash.json").read_text())
    assert cfg["reduced"] == ["num_hidden_layers", "n_routed_experts"]
    assert cfg["published"] == {"num_hidden_layers": 48, "n_routed_experts": 256}


def test_a_selection_without_the_bias_fails_the_pick_gap(monkeypatch):
    """A program that picks its experts on the scores alone (the correction
    bias dropped) reads a pick gap of the bias's size, past the limit."""
    from med_tpu_torch.models.mimo import MiMoMoE

    def select(self, scores):
        return torch.topk(scores, self.arch.top_k, dim=-1).indices

    monkeypatch.setattr(MiMoMoE, "select", select)
    result = run("mimo_v2_flash.train")
    assert not result["correct"]
    assert result["checks"]["pick_gap"]["value"] > 10 * result["checks"]["pick_gap"]["limit"]
