"""Per-temporal-layer LambdaModifier targeting
(utils/BitrateTargeting/GuessLambdaModifiers.cpp dual).

Iteratively guesses the LambdaModifier vector that makes each temporal
layer hit its target bitrate: secant interpolation through the last two
(modifier, bitrate) observations per layer, falling back to a
proportional increment on the first round, with intra dampening
(log-compressed step) and inter dampening (1/(50*cumulativeDelta+1))
from changes at previous layers.
"""

from __future__ import annotations

import math


def _increment(initial_adjustment, target, prev_mod, prev_rate):
    extrapolated = prev_mod * target / prev_rate
    return prev_mod + initial_adjustment * (extrapolated - prev_mod)


def _interpolate(target, p1, p2):
    (m1, r1), (m2, r2) = p1, p2
    return m1 + (m1 - m2) / (r1 - r2) * (target - r1)


def guess_lambda_modifier(initial_adjustment, target, points,
                          inter_dampening):
    """points: list of (lambda_modifier, bitrate), oldest first."""
    if len(points) == 1 or points[-1][0] == points[-2][0] or \
            points[-1][1] == points[-2][1]:
        prelim = _increment(initial_adjustment, target, *points[-1])
    else:
        prelim = _interpolate(target, points[-1], points[-2])
    prev = points[-1][0]
    # intra dampening: log-compress the relative step
    inter = math.log(1.0 + abs(prelim - prev) / prev)
    prelim = prev * (1.0 - inter) if prelim < prev else prev * (1.0 + inter)
    # inter dampening, halved until positive
    while True:
        result = prev + inter_dampening * (prelim - prev)
        if result > 0.0:
            return result
        inter_dampening /= 2.0


def guess_lambda_modifiers(initial_adjustment, targets, meta_log):
    """meta_log: list of runs, each (lambda_modifiers, bitrates) vectors
    indexed by temporal layer; returns the next modifier vector."""
    cumulative_delta = 0.0
    out = []
    for i, target in enumerate(targets):
        points = [(run[0][i], run[1][i]) for run in meta_log[-2:]]
        damp = 1.0 / (50.0 * cumulative_delta + 1.0)
        new = guess_lambda_modifier(initial_adjustment, target, points, damp)
        old = points[-1][0]
        out.append(new)
        cumulative_delta += abs(new - old) / old
    return out
