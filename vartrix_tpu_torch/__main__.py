"""`python -m vartrix_tpu_torch ...` runs the CLI."""

from .driver import main

main()
