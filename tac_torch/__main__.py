"""``python -m tac_torch ...`` runs the command line (tac_torch.cli)."""

import sys

from tac_torch.cli import main

sys.exit(main())
