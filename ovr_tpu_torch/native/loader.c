/* Native raw-volume loader: mmap + multithreaded convert/normalize.
 *
 * The port's copy of ovr_tpu/native/loader.c: the reference's native data path
 * (CreateArray3DScalarFromFile, ovr/scene.cpp:181-245: read + endian swap;
 * convert_array1d, ovr/devices/optix7/array.cpp:68-82: dtype conversion;
 * integer normalization rules, ovr/devices/optix7/array.h:68-106) plus the
 * mmap strategy of ovr/common/vidi_filemap.h. Output is always float32 in
 * normalized units, ready to copy to the device.
 *
 * Exposed as the CPython extension `_ovr_native` (built into
 * ovr_tpu_torch/_build/):
 *   load_raw_f32(path: str, count: int, dtype: str, offset: int,
 *                big_endian: bool, nthreads: int) -> bytearray  # count*4
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <fcntl.h>
#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

typedef struct {
    const unsigned char *src;
    float *dst;
    size_t begin, end;
    char dtype;
    int big_endian;
} Job;

static uint16_t bswap16(uint16_t v) { return (uint16_t)((v >> 8) | (v << 8)); }
static uint32_t bswap32(uint32_t v) { return __builtin_bswap32(v); }
static uint64_t bswap64(uint64_t v) { return __builtin_bswap64(v); }

static void *convert_worker(void *arg)
{
    Job *j = (Job *)arg;
    const unsigned char *s = j->src;
    float *d = j->dst;
    size_t i;
    switch (j->dtype) {
    case 'B': { /* uint8 -> /255 */
        for (i = j->begin; i < j->end; ++i) d[i] = s[i] * (1.0f / 255.0f);
        break;
    }
    case 'b': { /* int8 -> /127, clamp at -1 */
        const int8_t *p = (const int8_t *)s;
        for (i = j->begin; i < j->end; ++i) {
            float v = p[i] * (1.0f / 127.0f);
            d[i] = v < -1.0f ? -1.0f : v;
        }
        break;
    }
    case 'H': { /* uint16 -> /65535 */
        const uint16_t *p = (const uint16_t *)s;
        for (i = j->begin; i < j->end; ++i) {
            uint16_t v = j->big_endian ? bswap16(p[i]) : p[i];
            d[i] = v * (1.0f / 65535.0f);
        }
        break;
    }
    case 'h': { /* int16 -> /32767, clamp */
        const uint16_t *p = (const uint16_t *)s;
        for (i = j->begin; i < j->end; ++i) {
            uint16_t raw = j->big_endian ? bswap16(p[i]) : p[i];
            int16_t sv;
            memcpy(&sv, &raw, 2);
            float v = sv * (1.0f / 32767.0f);
            d[i] = v < -1.0f ? -1.0f : v;
        }
        break;
    }
    case 'I': case 'L': { /* uint32 -> plain cast */
        const uint32_t *p = (const uint32_t *)s;
        for (i = j->begin; i < j->end; ++i) {
            uint32_t v = j->big_endian ? bswap32(p[i]) : p[i];
            d[i] = (float)v;
        }
        break;
    }
    case 'i': case 'l': { /* int32 -> plain cast */
        const uint32_t *p = (const uint32_t *)s;
        for (i = j->begin; i < j->end; ++i) {
            uint32_t raw = j->big_endian ? bswap32(p[i]) : p[i];
            int32_t sv;
            memcpy(&sv, &raw, 4);
            d[i] = (float)sv;
        }
        break;
    }
    case 'f': { /* float32 passthrough (+swap) */
        const uint32_t *p = (const uint32_t *)s;
        for (i = j->begin; i < j->end; ++i) {
            uint32_t raw = j->big_endian ? bswap32(p[i]) : p[i];
            memcpy(&d[i], &raw, 4);
        }
        break;
    }
    case 'd': { /* float64 -> float32 */
        const uint64_t *p = (const uint64_t *)s;
        for (i = j->begin; i < j->end; ++i) {
            uint64_t raw = j->big_endian ? bswap64(p[i]) : p[i];
            double dv;
            memcpy(&dv, &raw, 8);
            d[i] = (float)dv;
        }
        break;
    }
    }
    return NULL;
}

static size_t dtype_size(char c)
{
    switch (c) {
    case 'B': case 'b': return 1;
    case 'H': case 'h': return 2;
    case 'I': case 'i': case 'L': case 'l': case 'f': return 4;
    case 'd': return 8;
    default: return 0;
    }
}

static PyObject *load_raw_f32(PyObject *self, PyObject *args)
{
    const char *path, *dtype_str;
    unsigned long long count, offset;
    int big_endian, nthreads;
    if (!PyArg_ParseTuple(args, "sKsKpi", &path, &count, &dtype_str, &offset,
                          &big_endian, &nthreads))
        return NULL;
    char dtype = dtype_str[0];
    size_t esize = dtype_size(dtype);
    if (esize == 0) {
        PyErr_Format(PyExc_ValueError, "unknown dtype char '%c'", dtype);
        return NULL;
    }

    int fd = open(path, O_RDONLY);
    if (fd < 0)
        return PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    struct stat st;
    if (fstat(fd, &st) != 0 ||
        (unsigned long long)st.st_size < offset + count * esize) {
        close(fd);
        PyErr_Format(PyExc_ValueError,
                     "file too small for %llu elements at offset %llu: %s",
                     count, offset, path);
        return NULL;
    }

    /* map the containing pages (offset must be page-aligned for mmap) */
    size_t page = (size_t)sysconf(_SC_PAGESIZE);
    size_t map_off = (offset / page) * page;
    size_t delta = offset - map_off;
    size_t map_len = count * esize + delta;
    void *map = mmap(NULL, map_len, PROT_READ, MAP_PRIVATE, fd, (off_t)map_off);
    close(fd);
    if (map == MAP_FAILED)
        return PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    const unsigned char *src = (const unsigned char *)map + delta;

    /* a bytearray: numpy views it writable, so torch takes it as is */
    PyObject *out = PyByteArray_FromStringAndSize(NULL, (Py_ssize_t)(count * 4));
    if (!out) {
        munmap(map, map_len);
        return NULL;
    }
    float *dst = (float *)PyByteArray_AS_STRING(out);

    if (nthreads < 1) nthreads = 1;
    if (nthreads > 64) nthreads = 64;
    if ((size_t)nthreads > count) nthreads = count ? (int)count : 1;

    Py_BEGIN_ALLOW_THREADS
    pthread_t tids[64];
    Job jobs[64];
    size_t chunk = (count + nthreads - 1) / nthreads;
    int spawned = 0;
    for (int t = 0; t < nthreads; ++t) {
        size_t b = (size_t)t * chunk;
        size_t e = b + chunk < count ? b + chunk : count;
        if (b >= e) break;
        jobs[t].src = src; jobs[t].dst = dst; jobs[t].begin = b;
        jobs[t].end = e; jobs[t].dtype = dtype;
        jobs[t].big_endian = big_endian;
        if (t + 1 < nthreads && pthread_create(&tids[t], NULL, convert_worker,
                                               &jobs[t]) == 0) {
            spawned++;
        } else {
            convert_worker(&jobs[t]);  /* last chunk (or fallback) inline */
        }
    }
    for (int t = 0; t < spawned; ++t) pthread_join(tids[t], NULL);
    munmap(map, map_len);
    Py_END_ALLOW_THREADS

    return out;
}

static PyMethodDef methods[] = {
    {"load_raw_f32", load_raw_f32, METH_VARARGS,
     "load_raw_f32(path, count, dtype, offset, big_endian, nthreads) -> "
     "bytearray of float32"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_ovr_native", "native raw-volume loader", -1,
    methods,
};

PyMODINIT_FUNC PyInit__ovr_native(void) { return PyModule_Create(&moduledef); }
