"""The port's runtime: the train step on one device or a mesh and the
serving steps (``steps.py``), the optimizer (``optimizer.py``), and the
multi-device layer over ``torch.distributed``: the collectives
(``collectives.py``), the sharding rules (``sharding.py``), sequence-parallel
and ring attention (``sharded_attention.py``, ``ring_attention.py``), the
vocab-parallel losses (``losses.py``), the sequence-parallel recurrence
cores (``sequence_parallel.py``) and int8 gradient reduction
(``grad_compress.py``)."""
