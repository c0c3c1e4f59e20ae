"""The artifact-evaluation bench harness of the port (counterpart of
``tcgnn_tpu.bench``): the 14-graph sweep against torch incumbents, the
per-stage epoch ledger, the card's roofline floor, accuracy parity against
a dense oracle, the SGT tile counters and the CSV tools.  Every module runs
on the card unless given ``--device cpu``."""
