"""Linearizability checker behind the Checker seam.

The equivalent of ``checker/linearizable {:model (model/cas-register)
:algorithm :linear}``: the history is encoded on the host and searched by
the dense subset-lattice sweep, on the card through the CUDA kernels
(``device=None`` or ``"cuda"``) or on the host through their plain
PyTorch versions (``device="cpu"``). A history longer than one scan takes
the windowed long sweep; one that no dense table holds (many pending
ops, huge values) takes the general path's ladder (the sort search, then
the dense sweep under the chunked budget, else "unknown"). Results keep
the JAX checker's schema; an invalid result names the failed op and
carries the counterexample witness (checkers/witness.py). With
``opts["store_dir"]``, the witness and the encoded history
(``history[-<key>].npz``) are written there. A valid verdict of the
run's streaming check (``opts["stream_results"]``, stream/engine.py)
settles the history without a second sweep.
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
    # First slot-table width of the encoding (doubled until the pending
    # ops fit).
    k_slots = 24

    def __init__(self, model: Model | str = "cas-register", device=None,
                 time_budget_s: float | None = None, f_cap: int = 256):
        self.model = get_model(model) if isinstance(model, str) else model
        self.device = resolve_device(device)
        # Wall-clock bound on a long (windowed) sweep and on the general
        # path's ladder; expiry yields the tri-state "unknown".
        self.time_budget_s = time_budget_s
        # First frontier capacity of the general path's sort search.
        self.f_cap = f_cap

    @property
    def backend(self) -> str:
        return f"torch-dense-{'cuda' if self.device.type == 'cuda' else 'plain'}"

    def encode(self, history: Sequence[Op]) -> EncodedHistory:
        """Encode (after the model's op translation), doubling the slot
        table until the history's pending ops fit."""
        return self._encode_translated(self.model.prepare_history(history))

    def _encode_translated(self, history: Sequence[Op]) -> EncodedHistory:
        # The encode cache (store/encode_cache.py), off unless a CLI verb
        # activated it: its key covers exactly the encoder's input, so a
        # hit is bit-identical to encoding again.
        from ..store import encode_cache

        cached = encode_cache.lookup(history, self.model.name, self.k_slots)
        if cached is not None:
            return cached
        k = self.k_slots
        while True:
            try:
                enc = encode_history(history, self.model, k_slots=k)
                break
            except SlotOverflow:
                if k >= 4096:
                    raise
                k *= 2
        encode_cache.store(history, self.model.name, self.k_slots, enc)
        return enc

    def streamed_verdict(self, stream_results: dict | None,
                         key) -> dict | None:
        """`key`'s valid streamed verdict under this model among a run's
        stream_results, or None. An invalid or absent one takes the whole
        path: an invalid key needs its witness, and the two verdicts are
        equal, so checking again never flips one."""
        pre = (stream_results or {}).get(key)
        if not isinstance(pre, dict) or pre.get("model") != self.model.name:
            return None
        return pre if pre.get("valid") is True else None

    def _settle_streamed(self, pre: dict, opts: dict) -> dict:
        """The result of a history the streaming check already swept, and
        the encoded history the post-hoc path would have stored."""
        enc = pre.get("_enc")
        if opts.get("store_dir") and enc is not None:
            from ..store.store import write_encoded_tensor

            write_encoded_tensor(opts["store_dir"], opts.get("key"), enc,
                                 self.model.name)
        res = {"valid": True, "backend": "torch-dense-streamed",
               "op_count": int(pre.get("op_count", 0)), "streamed": True}
        for f in ("dead_step", "max_frontier", "configs_explored"):
            if f in pre:
                res[f] = int(pre[f])
        if "table_cells" in pre:
            res["overflow"] = False
            res["f_cap"] = int(pre["table_cells"])
            res["kernel"] = pre.get("kernel")
        return res

    def check(self, test: dict, history: Sequence[Op],
              opts: dict | None = None) -> dict[str, Any]:
        opts = opts or {}
        pre = self.streamed_verdict(opts.get("stream_results"),
                                    opts.get("key"))
        if pre is not None:
            return self._settle_streamed(pre, opts)
        # Fault-plane ops (nemesis start/stop) are not client operations.
        history = [op for op in history if op.process != "nemesis"]
        # Translate once, so the witness replay sees the op language the
        # encoder saw.
        history = self.model.prepare_history(history)
        enc = self._encode_translated(history)
        store_dir = (opts or {}).get("store_dir")
        if store_dir:
            # Empty encodings included: the store holds the checker's
            # input for every key.
            from ..store.store import write_encoded_tensor

            write_encoded_tensor(store_dir, (opts or {}).get("key"), enc,
                                 self.model.name)
        if enc.n_events == 0:
            return {"valid": True, "op_count": 0, "backend": self.backend}
        # f_cap_floor: the independent checker's batched sort tiers may
        # have proven smaller capacities overflow; the ladder starts past.
        res = self._check_device(
            enc, f_cap_floor=int((opts or {}).get("f_cap_floor", 0)))
        if res["valid"] is False:
            self._explain(res, enc, history, opts)
        return res

    def _check_device(self, enc: EncodedHistory,
                      f_cap_floor: int = 0) -> dict[str, Any]:
        from ..ops import wgl3, wgl3_kernels

        if wgl3.dense_config(self.model, wgl3.tight_k_slots(enc),
                             enc.max_value) is None:
            return self._check_general(enc, f_cap_floor)
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

    def _check_general(self, enc: EncodedHistory,
                       f_cap_floor: int) -> dict[str, Any]:
        """The general path (wgl3_kernels.check_encoded_general)."""
        from ..ops import wgl3_kernels

        out = wgl3_kernels.check_encoded_general(
            enc, self.model, f_cap=max(self.f_cap, f_cap_floor),
            time_budget_s=self.time_budget_s, device=self.device)
        res = {"valid": out["valid"],
               "backend": f"torch-{self.device.type}",
               "op_count": out["op_count"],
               "dead_step": out["dead_step"],
               "max_frontier": out["max_frontier"],
               # An exhausted ladder carries overflow and the error; every
               # exact rung reports no overflow.
               "overflow": out.get("overflow", False),
               "f_cap": out["f_cap"],
               "escalations": out["escalations"]}
        for extra in ("kernel", "error", "death_checkpoint"):
            if extra in out:
                res[extra] = out[extra]
        return res

    def _explain(self, res: dict, enc: EncodedHistory,
                 history: Sequence[Op], opts: dict | None) -> None:
        """Counterexample extraction: name the unexplainable op in the
        result and write the witness artifacts into the store.

        Ladder (never skipped silently):
          1. full replay from the start (complete lineage);
          2. past its effort cap: recover the frontier near dead_step with
             the dense sweep and replay only a window;
          3. where no dense table holds the history (or the death lies
             in the first window), a replay from the sort search's
             frontier at the start of the chunk it died in;
          4. if that fails too, an explicit "skipped" witness carrying
             each rung's failure."""
        from .witness import (WITNESS_WINDOW_STEPS, WitnessEffortExceeded,
                              reconstruct_witness,
                              reconstruct_witness_from_sort_checkpoint,
                              reconstruct_witness_windowed, write_witness)

        dead_step = int(res.get("dead_step", -1))
        # The sort search's death checkpoint (host arrays) is consumed here,
        # whichever rung gives the witness, and never reaches the result.
        ckpt = res.pop("death_checkpoint", None)
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
            except ValueError as e2:
                try:
                    w = reconstruct_witness_from_sort_checkpoint(
                        enc, self.model, history,
                        time_budget_s=self.time_budget_s, checkpoint=ckpt,
                        dead_step=dead_step, device=self.device)
                except (WitnessEffortExceeded, MemoryError) as e3:
                    w = _skipped_witness(dead_step, e, e2, e3)
            except WitnessEffortExceeded as e2:
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
