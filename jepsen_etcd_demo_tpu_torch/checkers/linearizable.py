"""Linearizability checker behind the Checker seam.

The equivalent of ``checker/linearizable {:model (model/cas-register)
:algorithm :linear}``: the history is encoded on the host and searched by
the dense subset-lattice sweep, on the card through the CUDA kernel
(``device=None`` or ``"cuda"``) or on the host through its plain PyTorch
version (``device="cpu"``). Results keep the JAX checker's schema; an
invalid result carries no counterexample witness (the witness ladder is a
later slice).
"""

from __future__ import annotations

from typing import Any, Sequence

from ..device import resolve_device
from ..models import Model, get_model
from ..ops.encode import EncodedHistory, SlotOverflow, encode_history
from ..ops.op import Op
from .base import Checker


class Linearizable(Checker):
    def __init__(self, model: Model | str = "cas-register", device=None):
        self.model = get_model(model) if isinstance(model, str) else model
        self.device = resolve_device(device)

    @property
    def backend(self) -> str:
        return f"torch-dense-{'cuda' if self.device.type == 'cuda' else 'plain'}"

    def encode(self, history: Sequence[Op]) -> EncodedHistory:
        """Encode (after the model's op translation), doubling the slot
        table until the history's pending ops fit."""
        history = self.model.prepare_history(history)
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
        enc = self.encode(history)
        if enc.n_events == 0:
            return {"valid": True, "op_count": 0, "backend": self.backend}
        return self._check_device(enc)

    def _check_device(self, enc: EncodedHistory) -> dict[str, Any]:
        from ..ops import wgl3_kernels

        results, _kernel = wgl3_kernels.check_batch_encoded_auto(
            [enc], self.model, self.device)
        out = results[0]
        return {"valid": out["valid"], "backend": self.backend,
                "op_count": enc.n_ops,
                "dead_step": int(out["dead_step"]),
                "max_frontier": int(out["max_frontier"]),
                "configs_explored": int(out["configs_explored"]),
                "overflow": False,
                "f_cap": out["table_cells"]}
