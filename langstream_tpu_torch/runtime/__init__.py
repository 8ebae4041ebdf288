"""The port's runtime servers."""
