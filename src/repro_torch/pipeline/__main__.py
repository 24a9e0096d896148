"""``python -m repro_torch.pipeline`` — see :mod:`repro_torch.pipeline.cli`."""
import sys

from repro_torch.pipeline.cli import main

sys.exit(main())
