"""PCFG caption generator over the 40 CelebA facial attributes.

Behavioural parity with mm_vox_celeb/pcfg.py:79-233: attribute grouping by
verb class (wear/has/is/na), 1-3-attribute merged noun phrases, pronoun /
determiner+gender alternation, negation flipping for 'No_*' attributes,
mutually-exclusive hair colours, and the random-sentence sampler used for
text augmentation.
"""

from __future__ import annotations

import random
from typing import List, Sequence, Tuple

import numpy as np

ATTR = [
    '5_o_Clock_Shadow', 'Arched_Eyebrows', 'Attractive', 'Bags_Under_Eyes',
    'Bald', 'Bangs', 'Big_Lips', 'Big_Nose', 'Black_Hair', 'Blond_Hair',
    'Blurry', 'Brown_Hair', 'Bushy_Eyebrows', 'Chubby', 'Double_Chin',
    'Eyeglasses', 'Goatee', 'Gray_Hair', 'Heavy_Makeup', 'High_Cheekbones',
    'Male', 'Mouth_Slightly_Open', 'Mustache', 'Narrow_Eyes', 'No_Beard',
    'Oval_Face', 'Pale_Skin', 'Pointy_Nose', 'Receding_Hairline',
    'Rosy_Cheeks', 'Sideburns', 'Smiling', 'Straight_Hair', 'Wavy_Hair',
    'Wearing_Earrings', 'Wearing_Hat', 'Wearing_Lipstick', 'Wearing_Necklace',
    'Wearing_Necktie', 'Young'
]
ATTR_NP = np.array(ATTR)

NAME = [a.replace('No_', '').replace('Wearing_', '').replace('_', ' ').lower()
        for a in ATTR]
NAME[0] = "5 o'clock shadow"
NAME = np.array(NAME)
GET_NAME = {a: NAME[i] for i, a in enumerate(ATTR)}

_WEAR = {'Eyeglasses', 'Goatee', 'Wearing_Earrings', 'Wearing_Hat',
         'Wearing_Lipstick', 'Wearing_Necklace', 'Wearing_Necktie'}
_IS = {'Attractive', 'Bald', 'Blurry', 'Chubby', 'Male', 'Smiling', 'Young'}
_NA = {'Mouth_Slightly_Open'}
ATTR_VERB = {a: ('wear' if a in _WEAR else 'is' if a in _IS
                 else 'na' if a in _NA else 'has') for a in ATTR}

NEGATE_IDX = [ATTR.index(a) for a in ATTR if a.startswith('No_')]
GENDER_IDX = ATTR.index('Male')


def merge_and_pop(attr_list: List[str], p2=0.9, p3=0.85) -> str:
    """Pop 1-3 attribute names and join them (pcfg.py:120-133)."""
    picked = [attr_list.pop(0)]
    if attr_list and random.random() < p2:
        picked.append(attr_list.pop(0))
    if attr_list and random.random() < p3:
        picked.append(attr_list.pop(0))
    if len(picked) == 1:
        return picked[0]
    if len(picked) == 2:
        return f'{picked[0]} and {picked[1]}'
    return f'{picked[0]}, {picked[1]} and {picked[2]}'


def generate_phrase(male: Tuple[bool, float] = (True, 0.5),
                    attr: Tuple[str, str] = ('is', 'male')) -> str:
    """One sentence for one (verb-class, attributes) tuple
    (pcfg.py:136-180)."""
    pn = 'he' if male[0] else 'she'
    if random.random() > male[1]:
        det = 'a' if np.random.choice([1, 2]) == 1 else 'this'
        if random.random() < 0.75:
            gender = (random.choice(['male', 'man']) if male[0]
                      else random.choice(['female', 'woman']))
        else:
            gender = 'person'
        np_ = f'{det} {gender}'
    else:
        np_ = pn

    verb_class, attributes = attr
    if verb_class == 'is':
        vp = f'{np_} is {attributes}'
    elif verb_class == 'has':
        vp = f'{np_} has {attributes}'
    elif verb_class == 'wear':
        wear_verb = 'wears' if np.random.choice([1, 2]) == 1 \
            else 'is wearing'
        vp = f'{np_} {wear_verb} {attributes}'
    else:
        raise ValueError(verb_class)
    return vp[0].upper() + vp[1:] + '.'


def generate(pred: np.ndarray, n: int = 10) -> List[str]:
    """n caption variants from a 40-dim boolean attribute vector
    (pcfg.py:79-118).  NB mutates pred's negated entries like the
    reference."""
    pred[NEGATE_IDX] = ~pred[NEGATE_IDX]

    attr = list(ATTR_NP[pred])
    random.shuffle(attr)
    wear_list = [GET_NAME[a] for a in attr if ATTR_VERB[a] == 'wear']
    has_list = [GET_NAME[a] for a in attr if ATTR_VERB[a] == 'has']
    is_list = [GET_NAME[a] for a in attr
               if ATTR_VERB[a] == 'is' and a != 'Male']

    attr_tuples = []
    while wear_list or has_list or is_list:
        p = np.array([len(wear_list), len(has_list), len(is_list)], float)
        c = np.random.choice([1, 2, 3], p=p / p.sum())
        if c == 1:
            attr_tuples.append(('wear', merge_and_pop(wear_list)))
        elif c == 2:
            attr_tuples.append(('has', merge_and_pop(has_list)))
        else:
            attr_tuples.append(('is', merge_and_pop(is_list)))

    sentences = []
    for _ in range(n):
        phrases = []
        first = True
        for t in attr_tuples:
            male = (bool(pred[GENDER_IDX]), 0.5 if first else 0.85)
            first = False
            phrases.append(generate_phrase(male, t))
        sentences.append(' '.join(phrases))
    return sentences


def mutual_exclusive(pred: np.ndarray, subset: Sequence[str]) -> np.ndarray:
    if sum(pred[ATTR.index(a)] for a in subset) > 1:
        keep = random.randint(0, len(subset) - 1)
        for i, a in enumerate(subset):
            pred[ATTR.index(a)] = (i == keep)
    return pred


def generate_random_sentences(n_attr: int = 8, n_sent: int = 16) -> List[str]:
    """Random attribute vectors -> captions (pcfg.py:198-214), for text
    augmentation."""
    sentences = []
    for _ in range(n_sent):
        pred = np.random.rand(40) < (n_attr / 40)
        pred = mutual_exclusive(
            pred, ['Black_Hair', 'Blond_Hair', 'Brown_Hair', 'Gray_Hair'])
        pred[GENDER_IDX] = random.random() < 0.5
        for off in ('Attractive', 'Brown_Hair', 'Mouth_Slightly_Open',
                    'Blurry', 'Smiling'):
            pred[ATTR.index(off)] = False
        sentences += generate(pred, 1)
    return sentences
