"""The port's runtime: the train and serving steps (``steps.py``) and the
optimizer (``optimizer.py``); the multi-device runtime (sharding, sharded
attention, vocab-parallel losses) waits for ROADMAP A9."""
