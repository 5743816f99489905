"""Operations and bytes of the hand-written kernel families, from a cell's
shapes (one file a family). Each input byte counts once and each output
byte once, whatever a kernel reads again; operations are what the algorithm
needs, not what one kernel's contract makes it do, so a later kernel that
reads or recomputes differently is judged on the same count."""
