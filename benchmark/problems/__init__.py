"""Problem families: each module builds the program's problem and the
reference's from a configuration."""
