"""Model configurations of the paper (port of `repro.configs`, MLPs)."""
