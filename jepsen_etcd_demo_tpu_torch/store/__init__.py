"""On-disk run persistence: the jepsen.store equivalent.

store/<test-name>/<timestamp>/ holds the test config, the full history,
the results, the charts and logs, with `latest` and `current` symlinks
per test name and at the root; the layout and file formats are the JAX
package's, so either package's `analyze` reads the other's runs. The
history is JSONL for the host, with .npz files of the encoded event
tensors the checker consumed (the device plane)."""

from .store import (RunDir, Store, read_encoded_tensors,  # noqa: F401
                    write_encoded_tensor)
