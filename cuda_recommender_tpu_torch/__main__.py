import sys

from .cli.train import main

sys.exit(main())
