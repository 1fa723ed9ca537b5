"""Mandarin tone-sandhi rules (full reference parity).

Parity: the reference's ``text/tone_sandhi.py`` (ToneSandhi, :22-351), which
vendors the PaddleSpeech rule set: the 420-entry must-neutral-tone word
table (:24-63 — data, not expression), neutral-tone particle/suffix rules
incl. the 个-classifier and 上/下+来/去 rules (:75-120), 不/一 sandhi
(:122-156), third-tone sandhi with ``_split_word`` sub-word analysis
(:158-208), and all six segment merge passes (:215-343).

Dependency injection: the reference calls ``jieba.cut_for_search`` (:159)
and ``pypinyin.lazy_pinyin`` (:263,293) inside the rules. Those backends
are optional here — pass ``cut_for_search``/``finals_fn`` callables (the
frontend wires the real ones when installed); without them ``_split_word``
falls back to a dictionary heuristic over the built-in word table and the
two continuous-three-tone merge passes are skipped (they need per-word
tone lookups).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

# must-neutral-tone word table: linguistic data shared with the reference
# (tone_sandhi.py:24-63; originally PaddleSpeech, Apache-2.0)
MUST_NEURAL_TONE_WORDS = {
    '麻烦', '麻利', '鸳鸯', '高粱', '骨头', '骆驼', '马虎', '首饰', '馒头', '馄饨', '风筝',
    '难为', '队伍', '阔气', '闺女', '门道', '锄头', '铺盖', '铃铛', '铁匠', '钥匙', '里脊',
    '里头', '部分', '那么', '道士', '造化', '迷糊', '连累', '这么', '这个', '运气', '过去',
    '软和', '转悠', '踏实', '跳蚤', '跟头', '趔趄', '财主', '豆腐', '讲究', '记性', '记号',
    '认识', '规矩', '见识', '裁缝', '补丁', '衣裳', '衣服', '衙门', '街坊', '行李', '行当',
    '蛤蟆', '蘑菇', '薄荷', '葫芦', '葡萄', '萝卜', '荸荠', '苗条', '苗头', '苍蝇', '芝麻',
    '舒服', '舒坦', '舌头', '自在', '膏药', '脾气', '脑袋', '脊梁', '能耐', '胳膊', '胭脂',
    '胡萝', '胡琴', '胡同', '聪明', '耽误', '耽搁', '耷拉', '耳朵', '老爷', '老实', '老婆',
    '老头', '老太', '翻腾', '罗嗦', '罐头', '编辑', '结实', '红火', '累赘', '糨糊', '糊涂',
    '精神', '粮食', '簸箕', '篱笆', '算计', '算盘', '答应', '笤帚', '笑语', '笑话', '窟窿',
    '窝囊', '窗户', '稳当', '稀罕', '称呼', '秧歌', '秀气', '秀才', '福气', '祖宗', '砚台',
    '码头', '石榴', '石头', '石匠', '知识', '眼睛', '眯缝', '眨巴', '眉毛', '相声', '盘算',
    '白净', '痢疾', '痛快', '疟疾', '疙瘩', '疏忽', '畜生', '生意', '甘蔗', '琵琶', '琢磨',
    '琉璃', '玻璃', '玫瑰', '玄乎', '狐狸', '状元', '特务', '牲口', '牙碜', '牌楼', '爽快',
    '爱人', '热闹', '烧饼', '烟筒', '烂糊', '点心', '炊帚', '灯笼', '火候', '漂亮', '滑溜',
    '溜达', '温和', '清楚', '消息', '浪头', '活泼', '比方', '正经', '欺负', '模糊', '槟榔',
    '棺材', '棒槌', '棉花', '核桃', '栅栏', '柴火', '架势', '枕头', '枇杷', '机灵', '本事',
    '木头', '木匠', '朋友', '月饼', '月亮', '暖和', '明白', '时候', '新鲜', '故事', '收拾',
    '收成', '提防', '挖苦', '挑剔', '指甲', '指头', '拾掇', '拳头', '拨弄', '招牌', '招呼',
    '抬举', '护士', '折腾', '扫帚', '打量', '打算', '打点', '打扮', '打听', '打发', '扎实',
    '扁担', '戒指', '懒得', '意识', '意思', '情形', '悟性', '怪物', '思量', '怎么', '念头',
    '念叨', '快活', '忙活', '志气', '心思', '得罪', '张罗', '弟兄', '开通', '应酬', '庄稼',
    '干事', '帮手', '帐篷', '希罕', '师父', '师傅', '巴结', '巴掌', '差事', '工夫', '岁数',
    '屁股', '尾巴', '少爷', '小气', '小伙', '将就', '对头', '对付', '寡妇', '家伙', '客气',
    '实在', '官司', '学问', '学生', '字号', '嫁妆', '媳妇', '媒人', '婆家', '娘家', '委屈',
    '姑娘', '姐夫', '妯娌', '妥当', '妖精', '奴才', '女婿', '头发', '太阳', '大爷', '大方',
    '大意', '大夫', '多少', '多么', '外甥', '壮实', '地道', '地方', '在乎', '困难', '嘴巴',
    '嘱咐', '嘟囔', '嘀咕', '喜欢', '喇嘛', '喇叭', '商量', '唾沫', '哑巴', '哈欠', '哆嗦',
    '咳嗽', '和尚', '告诉', '告示', '含糊', '吓唬', '后头', '名字', '名堂', '合同', '吆喝',
    '叫唤', '口袋', '厚道', '厉害', '千斤', '包袱', '包涵', '匀称', '勤快', '动静', '动弹',
    '功夫', '力气', '前头', '刺猬', '刺激', '别扭', '利落', '利索', '利害', '分析', '出息',
    '凑合', '凉快', '冷战', '冤枉', '冒失', '养活', '关系', '先生', '兄弟', '便宜', '使唤',
    '佩服', '作坊', '体面', '位置', '似的', '伙计', '休息', '什么', '人家', '亲戚', '亲家',
    '交情', '云彩', '事情', '买卖', '主意', '丫头', '丧气', '两口', '东西', '东家', '世故',
    '不由', '不在', '下水', '下巴', '上头', '上司', '丈夫', '丈人', '一辈', '那个', '菩萨',
    '父亲', '母亲', '咕噜', '邋遢', '费用', '冤家', '甜头', '介绍', '荒唐', '大人', '泥鳅',
    '幸福', '熟悉', '计划', '扑腾', '蜡烛', '姥爷', '照顾', '喉咙', '吉他', '弄堂', '蚂蚱',
    '凤凰', '拖沓', '寒碜', '糟蹋', '倒腾', '报复', '逻辑', '盘缠', '喽啰', '牢骚', '咖喱',
    '扫把', '惦记',
}

MUST_NOT_NEURAL_TONE_WORDS = {
    '男子', '女子', '分子', '原子', '量子', '莲子', '石子', '瓜子', '电子',
    '人人', '虎虎',
}


def _default_cut_for_search(word: str):
    """jieba.cut_for_search stand-in when jieba is unavailable: emit the
    in-dictionary 2-grams of the word (leftmost first) plus the word itself
    — the pieces search mode would surface for compound words."""
    pieces = [word[i:i + 2] for i in range(len(word) - 1)
              if word[i:i + 2] in MUST_NEURAL_TONE_WORDS
              or word[i:i + 2] in MUST_NOT_NEURAL_TONE_WORDS]
    return pieces + [word]


class ToneSandhi:
    """Reference ToneSandhi (tone_sandhi.py:22) with injectable backends."""

    def __init__(self,
                 cut_for_search: Optional[Callable[[str], Sequence[str]]] = None,
                 finals_fn: Optional[Callable[[str], List[str]]] = None):
        self.must_neural_tone_words = set(MUST_NEURAL_TONE_WORDS)
        self.must_not_neural_tone_words = set(MUST_NOT_NEURAL_TONE_WORDS)
        self.punc = "：，；。？！“”‘’':,;.?!"
        if cut_for_search is None:
            try:
                import jieba  # type: ignore
                cut_for_search = jieba.cut_for_search
            except ImportError:
                cut_for_search = _default_cut_for_search
        self._cut_for_search = cut_for_search
        if finals_fn is None:
            try:
                from pypinyin import lazy_pinyin, Style  # type: ignore

                def finals_fn(w):
                    return lazy_pinyin(w, neutral_tone_with_five=True,
                                       style=Style.FINALS_TONE3)
            except ImportError:
                finals_fn = None
        self._finals_fn = finals_fn

    def add_neutral_words(self, words):
        self.must_neural_tone_words.update(words)

    # -- per-word rules (tone_sandhi.py:75-208) -----------------------------

    def _neural_sandhi(self, word: str, pos: str,
                       finals: List[str]) -> List[str]:
        # reduplication words for n. and v. e.g. 奶奶, 试试, 旺旺 (:79-83)
        for j, item in enumerate(word):
            if j - 1 >= 0 and item == word[j - 1] and pos[0] in {
                    'n', 'v', 'a'
            } and word not in self.must_not_neural_tone_words:
                finals[j] = finals[j][:-1] + '5'
        ge_idx = word.find('个')
        if len(word) >= 1 and word[-1] in '吧呢啊呐噻嘛吖嗨呐哦哒额滴哩哟喽啰耶喔诶':
            finals[-1] = finals[-1][:-1] + '5'
        elif len(word) >= 1 and word[-1] in '的地得':
            finals[-1] = finals[-1][:-1] + '5'
        # 了着过 rule is commented out in the reference (:90-91); kept so
        elif len(word) > 1 and word[-1] in '们子' and pos in {
                'r', 'n'
        } and word not in self.must_not_neural_tone_words:
            finals[-1] = finals[-1][:-1] + '5'
        # e.g. 桌上, 地下, 家里 (:97)
        elif len(word) > 1 and word[-1] in '上下里' and pos in {'s', 'l', 'f'}:
            finals[-1] = finals[-1][:-1] + '5'
        # e.g. 上来, 下去 (:100)
        elif len(word) > 1 and word[-1] in '来去' and word[-2] in '上下进出回过起开':
            finals[-1] = finals[-1][:-1] + '5'
        # 个 as classifier (:103-106)
        elif (ge_idx >= 1 and
              (word[ge_idx - 1].isnumeric() or
               word[ge_idx - 1] in '几有两半多各整每做是')) or word == '个':
            finals[ge_idx] = finals[ge_idx][:-1] + '5'
        else:
            if word in self.must_neural_tone_words or \
                    word[-2:] in self.must_neural_tone_words:
                finals[-1] = finals[-1][:-1] + '5'

        # sub-word pass (:112-119)
        word_list = self._split_word(word)
        finals_list = [finals[:len(word_list[0])],
                       finals[len(word_list[0]):]]
        for i, w in enumerate(word_list):
            # conventional neutral in Chinese
            if (w in self.must_neural_tone_words or
                    w[-2:] in self.must_neural_tone_words) and finals_list[i]:
                finals_list[i][-1] = finals_list[i][-1][:-1] + '5'
        finals = sum(finals_list, [])
        return finals

    def _bu_sandhi(self, word: str, finals: List[str]) -> List[str]:
        # e.g. 看不懂 (:124)
        if len(word) == 3 and word[1] == '不':
            finals[1] = finals[1][:-1] + '5'
        else:
            for i, char in enumerate(word):
                # 不 before tone4 -> bu2, e.g. 不怕 (:129)
                if char == '不' and i + 1 < len(word) and \
                        finals[i + 1][-1] == '4':
                    finals[i] = finals[i][:-1] + '2'
        return finals

    def _yi_sandhi(self, word: str, finals: List[str]) -> List[str]:
        # 一 inside a pure number sequence keeps yi1, e.g. 一零零 (:136-138)
        if word.find('一') != -1 and all(
                item.isnumeric() for item in word if item != '一'):
            return finals
        # 一 between reduplicated verbs -> yi5, e.g. 看一看 (:140)
        elif len(word) == 3 and word[1] == '一' and word[0] == word[-1]:
            finals[1] = finals[1][:-1] + '5'
        # ordinal 第一 -> yi1 (:143)
        elif word.startswith('第一'):
            finals[1] = finals[1][:-1] + '1'
        else:
            for i, char in enumerate(word):
                if char == '一' and i + 1 < len(word):
                    # before tone4 -> yi2, e.g. 一段 (:149)
                    if finals[i + 1][-1] == '4':
                        finals[i] = finals[i][:-1] + '2'
                    # before non-tone4 -> yi4, unless punctuation follows
                    # (:151-155)
                    else:
                        if word[i + 1] not in self.punc:
                            finals[i] = finals[i][:-1] + '4'
        return finals

    def _split_word(self, word: str) -> List[str]:
        """Two-part word split via search-mode segmentation (:158-169)."""
        word_list = list(self._cut_for_search(word))
        word_list = sorted(word_list, key=lambda i: len(i), reverse=False)
        first_subword = word_list[0]
        first_begin_idx = word.find(first_subword)
        if first_begin_idx == 0:
            second_subword = word[len(first_subword):]
            new_word_list = [first_subword, second_subword]
        else:
            second_subword = word[:-len(first_subword)]
            new_word_list = [second_subword, first_subword]
        return new_word_list

    def _three_sandhi(self, word: str, finals: List[str]) -> List[str]:
        if len(word) == 2 and self._all_tone_three(finals):
            finals[0] = finals[0][:-1] + '2'
        elif len(word) == 3:
            word_list = self._split_word(word)
            if self._all_tone_three(finals):
                # disyllabic + monosyllabic, e.g. 蒙古/包 (:178)
                if len(word_list[0]) == 2:
                    finals[0] = finals[0][:-1] + '2'
                    finals[1] = finals[1][:-1] + '2'
                # monosyllabic + disyllabic, e.g. 纸/老虎 (:182)
                elif len(word_list[0]) == 1:
                    finals[1] = finals[1][:-1] + '2'
            else:
                finals_list = [finals[:len(word_list[0])],
                               finals[len(word_list[0]):]]
                if len(finals_list) == 2:
                    for i, sub in enumerate(finals_list):
                        # e.g. 所有/人 (:190)
                        if self._all_tone_three(sub) and len(sub) == 2:
                            finals_list[i][0] = \
                                finals_list[i][0][:-1] + '2'
                        # e.g. 好/喜欢 (:193)
                        elif (i == 1 and not self._all_tone_three(sub)
                              and finals_list[i][0][-1] == '3'
                              and finals_list[0][-1][-1] == '3'):
                            finals_list[0][-1] = \
                                finals_list[0][-1][:-1] + '2'
                        # reference recomputes finals inside the loop
                        # (:198) — reproduced for output parity
                        finals = sum(finals_list, [])
        # idiom: split into two 2-char halves (:200-206)
        elif len(word) == 4:
            finals_list = [finals[:2], finals[2:]]
            finals = []
            for sub in finals_list:
                if self._all_tone_three(sub):
                    sub[0] = sub[0][:-1] + '2'
                finals += sub
        return finals

    @staticmethod
    def _all_tone_three(finals: List[str]) -> bool:
        return all(x[-1] == '3' for x in finals)

    # -- segment merge passes (tone_sandhi.py:215-343) ----------------------

    def _merge_bu(self, seg):
        """Merge 不 with the word behind it (:215-227)."""
        new_seg = []
        last_word = ''
        for word, pos in seg:
            if last_word == '不':
                word = last_word + word
            if word != '不':
                new_seg.append((word, pos))
            last_word = word[:]
        if last_word == '不':
            new_seg.append((last_word, 'd'))
            last_word = ''
        return new_seg

    def _merge_yi(self, seg):
        """Merge 一 between reduplicated verbs (听/一/听 -> 听一听) and a
        lone 一 with the word behind it (:235-256)."""
        new_seg = []
        # function 1
        for i, (word, pos) in enumerate(seg):
            if (i - 1 >= 0 and word == '一' and i + 1 < len(seg)
                    and seg[i - 1][0] == seg[i + 1][0]
                    and seg[i - 1][1] == 'v'):
                # reference indexes new_seg by the seg position (:241);
                # reproduced (valid when no earlier merges shifted entries)
                new_seg[i - 1][0] = \
                    new_seg[i - 1][0] + '一' + new_seg[i - 1][0]
            else:
                if (i - 2 >= 0 and seg[i - 1][0] == '一'
                        and seg[i - 2][0] == word and pos == 'v'):
                    continue
                else:
                    new_seg.append([word, pos])
        seg = new_seg
        new_seg = []
        # function 2
        for i, (word, pos) in enumerate(seg):
            if new_seg and new_seg[-1][0] == '一':
                new_seg[-1][0] = new_seg[-1][0] + word
            else:
                new_seg.append([word, pos])
        return new_seg

    def _merge_continuous_three_tones(self, seg):
        """Merge adjacent all-tone-three words (:259-283). Needs a pinyin
        backend; pass-through without one."""
        if self._finals_fn is None:
            return [list(p) for p in seg]
        new_seg = []
        sub_finals_list = [self._finals_fn(word) for (word, pos) in seg]
        assert len(sub_finals_list) == len(seg)
        merge_last = [False] * len(seg)
        for i, (word, pos) in enumerate(seg):
            if (i - 1 >= 0 and self._all_tone_three(sub_finals_list[i - 1])
                    and self._all_tone_three(sub_finals_list[i])
                    and not merge_last[i - 1]):
                # reduplication must stay separate for _neural_sandhi (:273)
                if not self._is_reduplication(seg[i - 1][0]) and \
                        len(seg[i - 1][0]) + len(seg[i][0]) <= 3:
                    new_seg[-1][0] = new_seg[-1][0] + seg[i][0]
                    merge_last[i] = True
                else:
                    new_seg.append([word, pos])
            else:
                new_seg.append([word, pos])
        return new_seg

    @staticmethod
    def _is_reduplication(word: str) -> bool:
        return len(word) == 2 and word[0] == word[1]

    def _merge_continuous_three_tones_2(self, seg):
        """Merge when last char of word i-1 and first char of word i are
        both tone three (:289-311)."""
        if self._finals_fn is None:
            return [list(p) for p in seg]
        new_seg = []
        sub_finals_list = [self._finals_fn(word) for (word, pos) in seg]
        assert len(sub_finals_list) == len(seg)
        merge_last = [False] * len(seg)
        for i, (word, pos) in enumerate(seg):
            if (i - 1 >= 0 and sub_finals_list[i - 1][-1][-1] == '3'
                    and sub_finals_list[i][0][-1] == '3'
                    and not merge_last[i - 1]):
                if not self._is_reduplication(seg[i - 1][0]) and \
                        len(seg[i - 1][0]) + len(seg[i][0]) <= 3:
                    new_seg[-1][0] = new_seg[-1][0] + seg[i][0]
                    merge_last[i] = True
                else:
                    new_seg.append([word, pos])
            else:
                new_seg.append([word, pos])
        return new_seg

    def _merge_er(self, seg):
        """Merge erhua 儿 into the preceding word (:313-320)."""
        new_seg = []
        for i, (word, pos) in enumerate(seg):
            if i - 1 >= 0 and word == '儿' and seg[i - 1][0] != '#':
                new_seg[-1][0] = new_seg[-1][0] + seg[i][0]
            else:
                new_seg.append([word, pos])
        return new_seg

    def _merge_reduplication(self, seg):
        """Merge adjacent identical words (:322-330)."""
        new_seg = []
        for i, (word, pos) in enumerate(seg):
            if new_seg and word == new_seg[-1][0]:
                new_seg[-1][0] = new_seg[-1][0] + seg[i][0]
            else:
                new_seg.append([word, pos])
        return new_seg

    # -- public api ----------------------------------------------------------

    def pre_merge_for_modify(self, seg) -> List[Tuple[str, str]]:
        """All six merge passes in reference order (:332-343)."""
        seg = self._merge_bu(seg)
        try:
            seg = self._merge_yi(seg)
        except Exception:
            print('_merge_yi failed')
        seg = self._merge_reduplication(seg)
        seg = self._merge_continuous_three_tones(seg)
        seg = self._merge_continuous_three_tones_2(seg)
        seg = self._merge_er(seg)
        return [tuple(p) for p in seg]

    def modified_tone(self, word: str, pos: str,
                      finals: List[str]) -> List[str]:
        """Rule pipeline (:345-351)."""
        finals = self._bu_sandhi(word, finals)
        finals = self._yi_sandhi(word, finals)
        finals = self._neural_sandhi(word, pos, finals)
        finals = self._three_sandhi(word, finals)
        return finals
