"""A host worker of the harness (`harness.Workers`): reads one pickled
(function, items) from standard input and writes the pickled list of
function(item), in order, to standard output.  It runs numpy and the
reference only and never touches the card."""

import pickle
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    out = sys.stdout.buffer
    sys.stdout = sys.stderr         # a stray print cannot reach the pipe
    fn, items = pickle.load(sys.stdin.buffer)
    out.write(pickle.dumps([fn(x) for x in items]))
    out.flush()


if __name__ == "__main__":
    main()
