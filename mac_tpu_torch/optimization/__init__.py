"""Frank-Wolfe and its LP oracle."""
