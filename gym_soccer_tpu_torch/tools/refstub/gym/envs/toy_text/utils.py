"""gym 0.26's categorical_sample, reproduced per its documented semantics:
float64 cumulative sum over the (ordered, duplicate-preserving) probability
list, one uniform double from the generator, first-exceedance index.
"""
import numpy as np


def categorical_sample(prob_n, np_random):
    prob_n = np.asarray(prob_n)
    csprob_n = np.cumsum(prob_n)
    return np.argmax(csprob_n > np_random.random())
