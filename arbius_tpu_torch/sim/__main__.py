# detlint: enforce[DET101,DET102,DET103,DET105]
"""`python -m arbius_tpu_torch.sim`: simnet's command line (sim/cli.py).
The run is guarded so that importing the module runs nothing."""
import sys

from arbius_tpu_torch.sim.cli import main

if __name__ == "__main__":
    sys.exit(main())
