"""Linearizability checker behind the Checker seam.

The equivalent of ``checker/linearizable {:model (model/cas-register)
:algorithm :linear}``: the history is encoded on the host and searched by
the dense subset-lattice sweep, on the card through the CUDA kernels
(``device=None`` or ``"cuda"``) or on the host through their plain
PyTorch versions (``device="cpu"``). A history longer than one scan takes
the windowed long sweep. Results keep the JAX checker's schema; an
invalid result names the failed op and carries the counterexample witness
(checkers/witness.py), written to ``opts["store_dir"]`` when given.
"""

from __future__ import annotations

from typing import Any, Sequence

from ..device import resolve_device
from ..models import Model, get_model
from ..ops.encode import EncodedHistory, SlotOverflow, encode_history
from ..ops.op import Op
from .base import Checker


def _skipped_witness(dead_step: int, *errors: BaseException) -> dict:
    """The marker recorded when every witness rung is exhausted: each
    rung's failure is named in the explanation."""
    chain = "; ".join(f"{type(e).__name__}: {e}" for e in errors)
    return {"valid": False, "witness": "skipped",
            "dead_step": dead_step,
            "explanation": f"witness reconstruction skipped: {chain}",
            "op": f"return step {dead_step}",
            "maximal_linearization": [], "final_configs": []}


class Linearizable(Checker):
    def __init__(self, model: Model | str = "cas-register", device=None,
                 time_budget_s: float | None = None):
        self.model = get_model(model) if isinstance(model, str) else model
        self.device = resolve_device(device)
        # Wall-clock bound on a long (windowed) sweep; expiry yields the
        # tri-state "unknown".
        self.time_budget_s = time_budget_s

    @property
    def backend(self) -> str:
        return f"torch-dense-{'cuda' if self.device.type == 'cuda' else 'plain'}"

    def encode(self, history: Sequence[Op]) -> EncodedHistory:
        """Encode (after the model's op translation), doubling the slot
        table until the history's pending ops fit."""
        return self._encode_translated(self.model.prepare_history(history))

    def _encode_translated(self, history: Sequence[Op]) -> EncodedHistory:
        k = 24
        while True:
            try:
                return encode_history(history, self.model, k_slots=k)
            except SlotOverflow:
                if k >= 4096:
                    raise
                k *= 2

    def check(self, test: dict, history: Sequence[Op],
              opts: dict | None = None) -> dict[str, Any]:
        # Fault-plane ops (nemesis start/stop) are not client operations.
        history = [op for op in history if op.process != "nemesis"]
        # Translate once, so the witness replay sees the op language the
        # encoder saw.
        history = self.model.prepare_history(history)
        enc = self._encode_translated(history)
        if enc.n_events == 0:
            return {"valid": True, "op_count": 0, "backend": self.backend}
        res = self._check_device(enc)
        if res["valid"] is False:
            self._explain(res, enc, history, opts)
        return res

    def _check_device(self, enc: EncodedHistory) -> dict[str, Any]:
        from ..ops import wgl3_kernels

        results, _kernel = wgl3_kernels.check_batch_encoded_auto(
            [enc], self.model, self.device,
            time_budget_s=self.time_budget_s)
        out = results[0]
        res = {"valid": out["valid"], "backend": self.backend,
               "op_count": enc.n_ops,
               "dead_step": int(out["dead_step"]),
               "max_frontier": int(out["max_frontier"]),
               "configs_explored": int(out["configs_explored"]),
               "overflow": bool(out["overflow"]),
               "f_cap": out["table_cells"]}
        if "error" in out:
            res["error"] = out["error"]
        return res

    def _explain(self, res: dict, enc: EncodedHistory,
                 history: Sequence[Op], opts: dict | None) -> None:
        """Counterexample extraction: name the unexplainable op in the
        result and write the witness artifacts into the store.

        Ladder (never skipped silently):
          1. full replay from the start (complete lineage);
          2. past its effort cap: recover the frontier near dead_step with
             the dense sweep and replay only a window;
          3. if that fails too, an explicit "skipped" witness carrying
             each rung's failure. (The JAX package's rung between 2 and
             3, a replay from the sort search's death checkpoint, needs
             the sort ladder, ROADMAP A-5.)"""
        from .witness import (WITNESS_WINDOW_STEPS, WitnessEffortExceeded,
                              reconstruct_witness,
                              reconstruct_witness_windowed, write_witness)

        dead_step = int(res.get("dead_step", -1))
        try:
            w = reconstruct_witness(enc, self.model, history)
        except WitnessEffortExceeded as e:
            try:
                if dead_step <= WITNESS_WINDOW_STEPS:
                    # The window would start at step 0: an exact re-run
                    # of the replay that just exceeded the cap.
                    raise ValueError(
                        "death inside the first window; windowed replay "
                        "would repeat the capped full replay")
                w = reconstruct_witness_windowed(
                    enc, self.model, dead_step, history,
                    device=self.device)
            except (ValueError, WitnessEffortExceeded) as e2:
                w = _skipped_witness(dead_step, e, e2)
        if w is None:
            return
        if w.get("witness") == "skipped":
            res["witness"] = "skipped"
            res["witness_detail"] = w["explanation"]
        else:
            res["failed_op"] = w["op"]
            res["witness"] = w["explanation"]
        store_dir = (opts or {}).get("store_dir")
        if store_dir:
            res["witness_file"] = write_witness(
                store_dir, (opts or {}).get("key"), w)
