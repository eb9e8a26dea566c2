"""iPER dataset with speed control (reference loader_ext.py:821-1214): the
port's copy of ``mmvid_tpu/data/iper.py``.

Same frame-folder layout as TextVideoDataset; adds the `slow` mode: per
sample a speed class {slow, normal, fast} scales frame_step by
{1/2, 1, 3/2} and appends "slow/normal/fast speed." to the caption
(loader_ext.py:1111-1135); plus the iPER caption dropout template
("person XXX dressed in YYY is performing ZZZ pose", :1167-1181).
Every ``random`` draw is the JAX module's, in its order.
"""

from __future__ import annotations

import random
from typing import Dict

from mmvid_tpu_torch.data.datasets import TextVideoDataset


class IPERDataset(TextVideoDataset):
    def __init__(self, folder, slow: bool = False, **kw):
        self.slow = slow
        # a fast clip needs 1.5x the span (loader_ext.py:871-878)
        kw.setdefault('skip_min_len_check', slow)
        super().__init__(folder, **kw)

    def _speed(self):
        """(frame_step, 'xxx speed.') per sample (loader_ext.py:1111-1135);
        a deterministic sample takes 'normal'."""
        if not self.slow:
            return None, ''
        num = 1 if self.deterministic else random.randint(0, 2)
        if num == 0:
            return self.frame_step // 2, 'slow speed.'
        if num == 1:
            return self.frame_step, 'normal speed.'
        return self.frame_step + self.frame_step // 2, 'fast speed.'

    def _drop_iper_sentence(self, description: str) -> str:
        """Template dropout for 'person XXX dressed in YYY is performing
        ZZZ pose.' captions (loader_ext.py:1167-1181)."""
        if self.deterministic:
            return description[:-1] + ','
        words = description.split(' ')
        xxx, yyy, zzz = words[1], words[4], words[7]
        xxx = 'a person' if random.random() < 0.5 else f'person {xxx}'
        yyy = '' if random.random() < 0.1 else f'dressed in {yyy}'
        pose = "'A' pose" if zzz == "'A'" else 'random pose'
        zzz = ('is performing some pose' if random.random() < 0.5
               else f'is performing {pose}')
        return f'{xxx} {yyy} {zzz},'

    def __getitem__(self, ind) -> Dict:
        frame_step, slow_desc = self._speed()
        frames, key, visual = self._get_video(ind, frame_step=frame_step)
        if self.video_only:
            return {'text': self._tokenize('dummy text'), 'target': frames,
                    'visual': visual[None], 'description': 'dummy text'}
        try:
            descriptions = self._descriptions(key)
            description = (descriptions[0] if self.deterministic
                           else random.choice(descriptions))
            if self.drop_sentence:
                description = self._drop_iper_sentence(description)
        except IndexError:
            return self.skip_sample(ind)
        if self.slow:
            description = description + ' ' + slow_desc
        out = {'text': self._tokenize(description), 'target': frames,
               'visual': visual[None], 'description': description}
        if self.return_neg:
            text = descriptions[0].lower().replace(',', '')
            others = list(set(self.attr_dict['text'].keys()) - {text})
            key_ = random.choice(self.attr_dict['text'][random.choice(
                others)])
            out['text_neg'] = self._tokenize(
                random.choice(self._descriptions(key_)))
        return out
