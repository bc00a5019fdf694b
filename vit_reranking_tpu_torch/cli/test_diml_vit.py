"""Thin entry point over cli.test_diml (reference test_diml_vit.py)."""

from .test_diml import main

if __name__ == "__main__":
    main()
