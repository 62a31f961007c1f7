"""`python -m dpm_solver_tpu_torch <cmd>`: the CLI (`dpm_solver_tpu_torch.cli`)."""

import sys

from dpm_solver_tpu_torch.cli import main

if __name__ == "__main__":
    main(sys.argv[1:])
