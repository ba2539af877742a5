"""python -m deblur_e_nerf_tpu_torch {train,val,test} <config.yaml> (see
cli.py)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
