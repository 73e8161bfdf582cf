"""Scripts of the port that lie on no render path."""
