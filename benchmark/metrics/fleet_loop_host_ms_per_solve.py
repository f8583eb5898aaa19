"""Host self milliseconds of the fleet's spans (`fleet.iteration`,
`fleet.backward`, `fleet.line_search`, `fleet.rollout`; not the `sync`
and `stage_terms` spans inside them) in one untraced call recorded by
`spans.measure`."""

from benchmark import spans


def read(ctx):
    return spans.self_ms(ctx, "fleet.")
