"""100 - the card's busy share over the traced window: the union of
every device operation's interval over the window's length."""
from chipbench.harness.readers import idle_pct


def read(rec):
    return idle_pct(rec)
