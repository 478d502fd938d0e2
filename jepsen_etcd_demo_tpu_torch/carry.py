"""Carry an encoded history across from the JAX package's arrays.

This system has no weights; what the two packages share is the encoded
history. ``encoded_from_numpy`` takes the JAX package's encoding as numpy
(the dict its ``EncodedHistory.to_arrays`` returns: ``events`` and the
scalar fields) and builds the port's ``EncodedHistory``, so one encoding
can be fed to both packages.
"""

from __future__ import annotations

import numpy as np

from .ops.encode import EVENT_WIDTH, EncodedHistory


def encoded_from_numpy(fields: dict[str, np.ndarray]) -> EncodedHistory:
    events = np.asarray(fields["events"], dtype=np.int32).reshape(
        -1, EVENT_WIDTH)
    n_events = int(fields.get("n_events", events.shape[0]))
    return EncodedHistory(events=events, n_events=n_events,
                          n_ops=int(fields["n_ops"]),
                          k_slots=int(fields["k_slots"]),
                          max_pending=int(fields["max_pending"]),
                          max_value=int(fields.get("max_value", 0)))
