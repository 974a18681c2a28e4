"""Node serving pipeline: the two engines composed into one servable
surface.

Layers (see docs/architecture.md, "Node serving pipeline"):

* ``service``  — the ``Node``: a fork-choice engine whose ``on_block``
  routes the state transition through the batched stf engine
  (``engine_backed_on_block``), behind a single-writer apply loop;
* ``ingest``   — bounded multi-producer FIFO work queue with
  back-pressure, feeding the apply loop;
* ``firehose`` — seeded concurrent load harness: N epochs of blocks +
  ≥100k-attestation gossip from concurrent producer threads, with
  journal-replay head/root parity vs the literal spec;
* ``admission`` — the survival layer: content-root dedup,
  bounded slot-expiring orphan pool with re-link, future-slot parking,
  malformed rejection, per-producer scoring/quarantine, and the
  dead-letter ring the apply loop's poison-pill containment feeds.

The node runs on whatever device its spec was built for
(``specs.get_spec(..., device=)``): every block it accepts goes through
the batched stf engine on that spec, so on a CUDA-built spec the epoch
boundary's fused update and the resident slot roots launch K2 from the
thread that runs the apply loop.
"""
from .ingest import IngestQueue
from .service import Node, engine_backed_on_block, recover_node

__all__ = ["IngestQueue", "Node", "engine_backed_on_block", "recover_node"]
